"""Plain oracle for the SSD intra-chunk (diagonal) term (port of
`repro/kernels/ssd/ref.py`).

Matches the non-kernel branch of `repro_torch.models.ssm.ssd_chunked`:

    y[i] = Σ_{j ≤ i} (C_i · B_j) · exp(Σ_{l=j+1..i} lA_l) · dt_j · x_j

The whole (Q, Q) decay and score blocks at once, in float32, the prefix
sum of the log-decays summed in float64 and rounded once (`torch.cumsum`
on the CPU accumulates so; on the card it would not).  It is the
oracle the kernel's plain version and the kernel are held against, and
the function whose autograd gives the op its backward.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_diag_ref"]


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
    B_: torch.Tensor,  # (B, NC, Q, H, N)
    C_: torch.Tensor,  # (B, NC, Q, H, N)
) -> torch.Tensor:
    f32 = torch.float32
    seg = _segsum(lA.to(f32).movedim(-1, -2))  # (B,NC,H,Q,Q)
    decay = torch.exp(seg)
    scores = torch.einsum("bcqhn,bckhn->bchqk", C_.to(f32), B_.to(f32))
    return torch.einsum("bchqk,bckh,bckhp->bcqhp", scores * decay, dt.to(f32), x.to(f32))
