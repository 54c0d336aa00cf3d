"""Plain PyTorch pieces of the references, written from the published
descriptions: RMSNorm, rotary embeddings (the split-half convention of
GPT-NeoX and Llama), grouped-query causal attention, the SwiGLU MLP, the
shifted cross-entropy with PaLM's z-loss, global-norm clipping, the
warm-up-and-cosine learning rate, AdamW, and the training step from the
published recipe (`train_steps`: the batch split into microbatches, the
mean of their gradients, global-norm clipping, then AdamW).

Everything runs in float32 with TF32 off, whatever the configuration's
compute dtype: the reference is what the program's lower-precision
arithmetic is held against.  `Precision` carries the one place where a
control lowers it: with ``fp8=True`` both operands of every projection are
rounded to float8 e4m3 (a scale per tensor, its largest magnitude at 448)
before the float32 product, the step below the configuration's bfloat16
compute.  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

__all__ = ["Precision", "adamw_update", "attention", "clip_by_global_norm", "f32_only",
           "learning_rate", "loss", "mlp", "rms_norm", "rope", "train_steps"]

F32 = torch.float32
_FP8_MAX = 448.0  # largest finite float8 e4m3fn


def f32_only() -> None:
    """No TF32 in float32 products, on the card or in cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in float32.
    The gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / _FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (q - x).detach()


@dataclasses.dataclass(frozen=True)
class Precision:
    fp8: bool = False

    def project(self, eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``einsum(eq, x, w)`` in float32, its operands in float8 for a control."""
        x, w = x.to(F32), w.to(F32)
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        return torch.einsum(eq, x, w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(F32)
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.to(F32)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (B, T, heads, D) by position: the first and second halves of
    each head form the pairs."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = positions.to(torch.float64)[:, None] * freqs  # (T, half)
    cos = torch.cos(ang).to(F32)[None, :, None, :]
    sin = torch.sin(ang).to(F32)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              block: int = 1024) -> torch.Tensor:
    """Causal attention of (B, T, H, D) queries over (B, T, KV, D) keys and
    values, each group of H / KV query heads on one key head; softmax in
    float32, a block of queries at a time so that a block's logits fit."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    kx = k.repeat_interleave(g, dim=2).permute(0, 2, 3, 1)  # (B, H, D, T)
    vx = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)  # (B, H, T, D)
    qx = q.permute(0, 2, 1, 3) / math.sqrt(d)
    outs = []
    for q0 in range(0, t, block):
        q1 = min(t, q0 + block)
        logits = qx[:, :, q0:q1] @ kx[..., :q1]  # (B, H, n, q1)
        keep = torch.arange(q0, q1, device=q.device)[:, None] >= torch.arange(q1, device=q.device)
        probs = torch.softmax(logits.masked_fill(~keep, -math.inf), dim=-1)
        outs.append(probs @ vx[:, :, :q1])
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3)


def mlp(x: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str, prec: Precision) -> torch.Tensor:
    """SwiGLU: wo(silu(x wi_gate) * (x wi_up))."""
    gate = prec.project("btd,df->btf", x, p[f"{prefix}.wi_gate"])
    up = prec.project("btd,df->btf", x, p[f"{prefix}.wi_up"])
    return prec.project("btf,fd->btd", F.silu(gate) * up, p[f"{prefix}.wo"])


def loss(logits: torch.Tensor, tokens: torch.Tensor, z_weight: float) -> torch.Tensor:
    """Mean over positions 0..T-2 of -log p(next token), plus z_weight times
    the mean squared log partition function (PaLM's z-loss)."""
    lg = logits[:, :-1].to(F32)
    logz = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, tokens[:, 1:, None].long())[..., 0]
    return (logz - tgt).mean() + z_weight * logz.square().mean()


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns the norm before."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).to(F32)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


def learning_rate(step: int, opt: dict) -> float:
    """Linear warm-up to ``learning_rate`` over ``warmup_steps``, then a
    cosine decay to a tenth of it at ``total_steps``; ``step`` counts from 1."""
    base, warm, total = opt["learning_rate"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return base * min(step / max(warm, 1), 1.0)
    frac = min(max(step - warm, 0) / max(total - warm, 1), 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * frac)))


@torch.no_grad()
def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 state: List[Tuple[torch.Tensor, torch.Tensor]], step: int, opt: dict) -> None:
    """One AdamW step in place (Loshchilov & Hutter): bias-corrected moments,
    the decay decoupled and applied to every parameter."""
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    lr = learning_rate(step, opt)
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    for p, g, (m, v) in zip(params, grads, state):
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.sub_(lr * ((m / bc1) / ((v / bc2).sqrt() + eps) + wd * p))


def train_steps(p: Dict[str, torch.Tensor], c: dict, batches: List[torch.Tensor], opt: dict,
                microbatches: int, prec: Precision = Precision(),
                *, loss_fn: Callable, on_step: Callable = None) -> List[float]:
    """Train ``p`` (float32 leaves, updated in place) on ``batches``, one
    step each; returns each step's loss (the mean over its microbatches).
    ``on_step(step, grads)`` sees each step's clipped gradients before the
    update.  ``loss_fn(p, c, tokens, prec, z_weight)`` is the loss of one
    microbatch (the family module's ``microbatch_loss``)."""
    names = list(p)
    leaves = [p[n].requires_grad_(True) for n in names]
    state = [(torch.zeros_like(t), torch.zeros_like(t)) for t in leaves]
    losses = []
    for step, tokens in enumerate(batches, start=1):
        total = 0.0
        rows = tokens.shape[0] // microbatches
        for m in range(microbatches):  # the mean of the microbatches' gradients, in .grad
            value = loss_fn(p, c, tokens[m * rows:(m + 1) * rows], prec, opt["z_loss"])
            (value / microbatches).backward()
            total += float(value.detach()) / microbatches
        grads = [t.grad for t in leaves]
        clip_by_global_norm(grads, opt["grad_clip"])
        if on_step is not None:
            on_step(step, dict(zip(names, grads)))
        adamw_update(leaves, grads, state, step, opt)
        losses.append(total)
        for t in leaves:
            t.grad = None
        del grads
    for t in leaves:
        t.requires_grad_(False)
    return losses
