"""Plain oracle for the SSD intra-chunk (diagonal) term (port of
`repro/kernels/ssd/ref.py`).

Matches the non-kernel branch of `repro_torch.models.ssm.ssd_chunked`:

    y[i] = Σ_{j ≤ i} (C_i · B_j) · exp(Σ_{l=j+1..i} lA_l) · dt_j · x_j

B and C may come per group, (..., G, N) with G dividing H: head h reads
group h // (H // G).  The whole (Q, Q) decay and score blocks at once, in
float32, the prefix
sum of the log-decays summed in float64 and rounded once (`torch.cumsum`
on the CPU accumulates so; on the card it would not).  It is the
oracle the kernel's plain version and the kernel are held against, and
the function whose autograd gives the op its backward.
"""

from __future__ import annotations

import torch

__all__ = ["heads", "ssd_diag_ref"]


def heads(a: torch.Tensor, h: int) -> torch.Tensor:
    """(..., G, N) → (..., h, N), head i reading group i // (h // G): the
    tensor itself when G = h, a stride-0 view for one group, else a copy."""
    g = a.shape[-2]
    if g == h:
        return a
    if h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    if g == 1:
        return a.expand(*a.shape[:-2], h, a.shape[-1])
    return a.repeat_interleave(h // g, dim=-2)


def _segsum(lA: torch.Tensor) -> torch.Tensor:
    q = lA.shape[-1]
    cs = torch.cumsum(lA.to(torch.float64), dim=-1).to(lA.dtype)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(q, device=lA.device)
    return diff.masked_fill(~(ii[:, None] >= ii[None, :]), -torch.inf)


def ssd_diag_ref(
    x: torch.Tensor,  # (B, NC, Q, H, P)
    dt: torch.Tensor,  # (B, NC, Q, H)
    lA: torch.Tensor,  # (B, NC, Q, H) log-decays (dt·A)
    B_: torch.Tensor,  # (B, NC, Q, H or G, N)
    C_: torch.Tensor,  # (B, NC, Q, H or G, N)
) -> torch.Tensor:
    f32 = torch.float32
    B_, C_ = heads(B_, x.shape[3]), heads(C_, x.shape[3])
    seg = _segsum(lA.to(f32).movedim(-1, -2))  # (B,NC,H,Q,Q)
    decay = torch.exp(seg)
    scores = torch.einsum("bcqhn,bckhn->bchqk", C_.to(f32), B_.to(f32))
    return torch.einsum("bchqk,bckh,bckhp->bcqhp", scores * decay, dt.to(f32), x.to(f32))
