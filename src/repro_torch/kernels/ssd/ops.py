"""Public SSD intra-chunk op: CUDA kernel on the card, plain version on the CPU, autograd.

Port of `repro/kernels/ssd/ops.py`, with its (B, NC, Q, H, ·) layout.

  * A CUDA tensor launches the hand-written kernel (`kernel.ssd_diag_cuda`)
    or raises.  The batch and chunk axes are flattened into one, as the
    reference flattens them for its kernel; B and C keep their strides and
    may come per group, (B, NC, Q, G, N) with G dividing H, so neither the
    grouped tensor nor a head-broadcast view (head stride 0) is copied out
    per head.
  * A CPU tensor takes `ssd_diag_plain`: the kernel's arithmetic in torch,
    tile by tile: the prefix sum of lA over the chunk, summed in float64
    and rounded once to float32 as the kernel sums it, and for each query
    tile the key tiles up to and including the diagonal one, each giving
    ``(C·Bᵀ) ⊙ exp(cs_i - cs_j) ⊙ dt_j`` on and below the diagonal and 0
    above it, times x.
  * The backward is autograd through `ref.ssd_diag_ref`, as the
    reference's custom VJP is the oracle's.
  * A meta tensor in a step traced for its costs (a `kernels.META_WATCHERS`
    listener) gets the kernel's output and scratch from its shape function
    (`kernels.meta_call`), with the flops of the oracle's two products.

The kernel is built for 64-row tiles (`kernel.BLOCK`) and computes the
products on the tensor cores, each f32 operand as two TF32 terms; the plain
version computes them in f32.  The plain version
takes the tile sizes as ``block_q`` and ``block_k``, and its result does
not depend on them beyond float32 rounding.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import meta_call
from repro_torch.kernels.ssd.kernel import BLOCK, ssd_diag_cuda
from repro_torch.kernels.ssd.ref import heads, ssd_diag_ref
from repro_torch.spans import SSD_DIAG_BACKWARD, span

__all__ = ["ssd_diag_chunk", "ssd_diag_plain"]


def ssd_diag_plain(
    x: torch.Tensor,  # (B, NC, Q, H, P)
    dt: torch.Tensor,  # (B, NC, Q, H)
    lA: torch.Tensor,  # (B, NC, Q, H)
    B_: torch.Tensor,  # (B, NC, Q, H or G, N)
    C_: torch.Tensor,  # (B, NC, Q, H or G, N)
    *,
    block_q: int = BLOCK,
    block_k: int = BLOCK,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device: (B,NC,Q,H,P) float32."""
    b, nc, q, h, p = x.shape
    f32 = torch.float32
    xf = x.to(f32).movedim(3, 2)  # (b, nc, h, q, p)
    Bf = heads(B_.to(f32), h).movedim(3, 2)
    Cf = heads(C_.to(f32), h).movedim(3, 2)
    dtf = dt.to(f32).movedim(3, 2)  # (b, nc, h, q)
    cs = torch.cumsum(lA.to(torch.float64), dim=2).to(f32).movedim(3, 2)  # (b, nc, h, q)
    pos = torch.arange(q, device=x.device)
    out = torch.empty((b, nc, h, q, p), dtype=f32, device=x.device)
    for q0 in range(0, q, block_q):
        q1 = min(q, q0 + block_q)
        acc = torch.zeros((b, nc, h, q1 - q0, p), dtype=f32, device=x.device)
        for k0 in range(0, q1, block_k):  # key tiles up to the tile's last query
            k1 = min(q, k0 + block_k)
            sc = Cf[..., q0:q1, :] @ Bf[..., k0:k1, :].transpose(-1, -2)
            live = pos[q0:q1, None] >= pos[None, k0:k1]
            decay = torch.exp(cs[..., q0:q1, None] - cs[..., None, k0:k1])
            w = torch.where(live, sc * decay * dtf[..., None, k0:k1], 0.0)
            acc = acc + w @ xf[..., k0:k1, :]
        out[..., q0:q1, :] = acc
    return out.movedim(2, 3).contiguous()


def _forward(x, dt, lA, B_, C_):
    if x.device.type == "cuda" or (x.device.type == "meta" and kernels.META_WATCHERS):
        b, nc = x.shape[:2]

        def flat(a):
            return a.to(torch.float32).reshape((b * nc,) + a.shape[2:])

        args = (flat(x).contiguous(), flat(dt).contiguous(), flat(lA).contiguous(),
                flat(B_), flat(C_))
        if x.device.type == "cuda":
            y = ssd_diag_cuda(*args)
        else:  # the launch's output and prefix-sum scratch
            y, _ = torch.empty_like(args[0]), torch.empty_like(args[1])
            q, h, p = x.shape[2:]
            flops = 2.0 * b * nc * h * q * q * (B_.shape[-1] + p)
            y = meta_call("ssd_diag", y, flops)
        return y.reshape(x.shape)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_diag_chunk runs on cuda or cpu, got {x.device}")
    return ssd_diag_plain(x, dt, lA, B_, C_)


class _SSDDiag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, lA, B_, C_):
        ctx.save_for_backward(x, dt, lA, B_, C_)
        return _forward(x, dt, lA, B_, C_)

    @staticmethod
    def backward(ctx, g):
        with span(SSD_DIAG_BACKWARD), torch.enable_grad():  # autograd through the oracle
            leaves = [a.detach().requires_grad_() for a in ctx.saved_tensors]
            out = ssd_diag_ref(*leaves)
            return torch.autograd.grad(out, leaves, g)


def ssd_diag_chunk(
    x: torch.Tensor,  # (B, NC, Q, H, P)
    dt: torch.Tensor,  # (B, NC, Q, H)
    lA: torch.Tensor,  # (B, NC, Q, H)
    B_: torch.Tensor,  # (B, NC, Q, G, N), G | H: per group, or per head (a stride-0 view will do)
    C_: torch.Tensor,  # (B, NC, Q, G, N)
) -> torch.Tensor:
    """The intra-chunk term (B,NC,Q,H,P) in float32; differentiable in every input."""
    return _SSDDiag.apply(x, dt, lA, B_, C_)
