"""Public flash-attention op: CUDA kernel on the card, plain version on the CPU, autograd.

Port of `repro/kernels/flash_attention/ops.py`.

  * A CUDA tensor launches a hand-written kernel
    (`kernel.flash_attention_cuda`: the tensor-core kernel for bfloat16
    with D % 8 == 0, the CUDA-core kernel otherwise) or raises.  The
    kernels mask the ragged edge of T and S themselves, so nothing is
    padded: the result is the reference's ``out[:, :t]`` of the padded call.
  * A CPU tensor takes `flash_attention_plain`: the kernels' online
    softmax over key tiles, in torch, with the same -1e30 sentinel, the
    same skipping of key tiles wholly in the future of a query tile, and
    the same 1e-30 floor on the denominator.  Both kernels multiply the
    float32 probabilities into V (the tensor-core kernel as two bfloat16
    terms, about 16 bits), and so does the plain version.
  * The backward: a CUDA tensor on the tensor-core route (bfloat16, D % 8
    == 0) runs the hand-written backward kernel
    (`kernel.flash_attention_bwd_cuda`) on the output and the row
    log-sum-exp its forward saved, or raises; every other input (the
    CUDA-core route, the CPU) differentiates through `ref.attention_ref`,
    as the reference's custom VJP is the oracle's VJP.
    `flash_attention_backward_plain` repeats the backward kernel's
    arithmetic in torch for the tests; the op never calls it.
  * A meta tensor in a step traced for its costs (a `kernels.META_WATCHERS`
    listener) gets the kernel's output from its shape function
    (`kernels.meta_call`), with the flops of the
    oracle's two products over the full T x S block, as the reference's
    cost analysis counts its oracle.  DTensor inputs run the op on their
    local shards (`parallel.spmd.sharded_call`).

The plain version takes its tiles from `kernel.tiles` (128 x 128 on the
tensor-core route, 64 x 64 on the CUDA-core one) unless ``block_q`` and
``block_k`` are given; its result does not depend on them beyond float32
rounding.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch import kernels
from repro_torch.kernels import meta_call
from repro_torch.kernels.flash_attention.kernel import (
    WGMMA_BLOCK_K, flash_attention_bwd_cuda, flash_attention_cuda, route, tiles)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.spans import FLASH_ATTENTION_BACKWARD, span

__all__ = ["flash_attention", "flash_attention_backward_plain", "flash_attention_plain"]

NEG_INF = -1e30


def flash_attention_plain(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    return_lse: bool = False,
):
    """The kernels' arithmetic in plain PyTorch, on any device: (B,T,H,D) in
    q's dtype; with ``return_lse`` also each row's float32 log-sum-exp of
    the scaled, masked scores (B,H,T), as ``(out, lse)``."""
    b, t, h, d = q.shape
    tile_q, tile_k = tiles(q.dtype, d)
    block_q = tile_q if block_q is None else block_q
    block_k = tile_k if block_k is None else block_k
    s, kv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    f32 = torch.float32
    heads = torch.arange(h, device=q.device) * kv // h  # query head -> KV head
    qf = q.to(f32).permute(0, 2, 1, 3)  # (b, h, t, d)
    kf = k.to(f32).index_select(2, heads).permute(0, 2, 1, 3)  # (b, h, s, d)
    vf = v.to(f32).index_select(2, heads).permute(0, 2, 1, 3)
    out = torch.empty((b, h, t, d), dtype=f32, device=q.device)
    lse = torch.empty((b, h, t), dtype=f32, device=q.device)
    for q0 in range(0, t, block_q):
        qt = qf[:, :, q0:q0 + block_q]
        n = qt.shape[2]
        qpos = torch.arange(q0, q0 + n, device=q.device)[:, None]
        m = torch.full((b, h, n, 1), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((b, h, n, 1), dtype=f32, device=q.device)
        acc = torch.zeros((b, h, n, d), dtype=f32, device=q.device)
        k_end = min(s, q0 + block_q) if causal else s
        for k0 in range(0, k_end, block_k):
            kt = kf[:, :, k0:k0 + block_k]
            vt = vf[:, :, k0:k0 + block_k]
            sc = (qt @ kt.transpose(-1, -2)) * scale
            if causal:
                kpos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
                sc = sc.masked_fill(qpos < kpos, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vt
            m = m_new
        out[:, :, q0:q0 + n] = acc / l.clamp_min(1e-30)
        lse[:, :, q0:q0 + n] = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    out = out.permute(0, 2, 1, 3).contiguous().to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention_backward_plain(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, T, H, D): the forward's output
    lse: torch.Tensor,  # (B, H, T): the forward's row log-sum-exp
    do: torch.Tensor,  # (B, T, H, D): the output's gradient
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
):
    """The backward kernel's arithmetic in plain PyTorch, in float32 on any
    device: (dq, dk, dv), each in its input's dtype.

    Di = rowsum(dO * o); over key tiles and the query tiles that see them,
    p = exp(s - lse) with the forward's masks, dp = dO.v^T and
    ds = p * (dp - Di); dv += p^T.dO, dk += scale * ds^T.q and
    dq += scale * ds.k.  dk and dv sum over the query heads of a KV head.
    The tiles are the dK/dV kernel's (64 queries, `WGMMA_BLOCK_K` keys)."""
    block_q, block_k = 64, WGMMA_BLOCK_K
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    f32 = torch.float32
    heads = torch.arange(h, device=q.device) * kv // h  # query head -> KV head
    qf = q.to(f32).permute(0, 2, 1, 3)  # (b, h, t, d)
    kf = k.to(f32).index_select(2, heads).permute(0, 2, 1, 3)  # (b, h, s, d)
    vf = v.to(f32).index_select(2, heads).permute(0, 2, 1, 3)
    dof = do.to(f32).permute(0, 2, 1, 3)
    di = (dof * o.to(f32).permute(0, 2, 1, 3)).sum(-1, keepdim=True)  # (b, h, t, 1)
    lse = lse.to(f32)[..., None]
    dq = torch.zeros((b, h, t, d), dtype=f32, device=q.device)
    dk = torch.zeros((b, h, s, d), dtype=f32, device=q.device)
    dv = torch.zeros((b, h, s, d), dtype=f32, device=q.device)
    for k0 in range(0, s, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        kpos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
        for q0 in range((k0 // block_q) * block_q if causal else 0, t, block_q):
            rows = slice(q0, q0 + block_q)
            qt, dot = qf[:, :, rows], dof[:, :, rows]
            p = torch.exp((qt @ kt.transpose(-1, -2)) * scale - lse[:, :, rows])
            if causal:
                qpos = torch.arange(q0, q0 + qt.shape[2], device=q.device)[:, None]
                p = p.masked_fill(qpos < kpos, 0.0)
            ds = p * (dot @ vt.transpose(-1, -2) - di[:, :, rows])
            dv[:, :, k0:k0 + block_k] += p.transpose(-1, -2) @ dot
            dk[:, :, k0:k0 + block_k] += ds.transpose(-1, -2) @ qt
            dq[:, :, rows] += ds @ kt
    grouped = lambda x: x.reshape(b, kv, h // kv, s, d).sum(2).permute(0, 2, 1, 3)
    return ((dq * scale).permute(0, 2, 1, 3).to(q.dtype), (grouped(dk) * scale).to(k.dtype),
            grouped(dv).to(v.dtype))


def _forward(q, k, v, causal, sm_scale, return_lse=False):
    if q.device.type == "cuda":
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=causal, sm_scale=sm_scale, return_lse=return_lse)
    if q.device.type == "meta" and kernels.META_WATCHERS:  # a step traced for its costs
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        b, t, h, d = q.shape
        flops = 2.0 * b * h * t * k.shape[1] * (d + v.shape[-1])
        return meta_call("flash_attention", torch.empty_like(q), flops)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                 return_lse=return_lse)


def _kernel_backward(q) -> bool:
    """Whether the op's backward runs the backward kernel: a CUDA tensor on
    the tensor-core route."""
    return q.device.type == "cuda" and route(q.dtype, q.shape[-1]) == "tensor_core"


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        ctx.causal, ctx.sm_scale = causal, sm_scale
        if _kernel_backward(q) and any(ctx.needs_input_grad[:3]):
            # the backward kernel takes contiguous q, k, v, the output and its log-sum-exp
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = _forward(q, k, v, causal, sm_scale, return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal, sm_scale)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with span(FLASH_ATTENTION_BACKWARD):
            if len(saved) == 5:  # q, k, v, out, lse: the backward kernel
                grads = flash_attention_bwd_cuda(*saved, g, causal=ctx.causal,
                                                 sm_scale=ctx.sm_scale)
            else:
                with torch.enable_grad():  # autograd through the oracle
                    leaves = [x.detach().requires_grad_() for x in saved]
                    out = attention_ref(*leaves, causal=ctx.causal, sm_scale=ctx.sm_scale)
                    grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None)


def flash_attention(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention forward (B,T,H,D) in q's dtype; differentiable in q, k, v."""
    if isinstance(q, DTensor):
        from repro_torch.parallel.spmd import sharded_call  # local: parallel imports the models

        return sharded_call("attention", lambda *a: _FlashAttention.apply(*a, causal, sm_scale),
                            q, k, v)
    return _FlashAttention.apply(q, k, v, causal, sm_scale)
