"""Plain reference for attention (port of `repro/kernels/flash_attention/ref.py`).

The whole (T, S) score block at once, in float32, masked with the same
finite -1e30 sentinel; the result comes back in q's dtype.  It is the
oracle the kernel's plain version and the kernel are held against, and the
function whose autograd gives the flash op its backward.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref"]


def attention_ref(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, t, kv, group, d)
    logits = torch.einsum(
        "btkgh,bskh->bkgts", qg.to(torch.float32), k.to(torch.float32)
    ) * scale
    if causal:
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s, device=q.device)[None, :])
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v.to(torch.float32))
    return out.reshape(b, t, h, d).to(q.dtype)
