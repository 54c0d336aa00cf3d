"""The shared EI tail: squared-distance block → masked Expected Improvement.

Port of `repro/kernels/ei_argmax/tile.py`.  Everything downstream of a
raw squared-distance block lives in this one function: the Matérn-5/2
rescale, the posterior mean and variance against the packed training
factors, de-standardization and EI.  The feature layout
(`repro_torch.core.fast_bo._packed_core`) calls it on the full (J,B,n)
block; the plain version of the fused kernel
(`repro_torch.kernels.ei_argmax.ops.ei_argmax_plain`) calls it on
(J,B,tile) blocks.  Every op is elementwise in the candidate axis or
contracts over B only, so a tile of columns computes what the full block
computes for those columns.

Shapes carry a leading job axis J (any leading batch shape works): d2
(J,B,m), pm/alpha (J,B), chol (J,B,B), the four scalars (J,), mask (J,m).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.gp import matern52_from_sqdist

__all__ = ["ei_from_sqdist"]

_SQRT2 = math.sqrt(2.0)
_SQRT2PI = math.sqrt(2.0 * math.pi)


def ei_from_sqdist(
    d2: torch.Tensor,  # (J, B, m) raw squared distances, training rows × candidates
    pm: torch.Tensor,  # (J, B) f32 packed-slot validity (1.0 for slots < t)
    alpha: torch.Tensor,  # (J, B) K⁻¹ y_train for the selected hyperparameters
    chol: torch.Tensor,  # (J, B, B) Cholesky factor of the masked training kernel
    ls: torch.Tensor,  # (J,) selected lengthscale
    y_mean: torch.Tensor,  # (J,) training-target mean
    y_std: torch.Tensor,  # (J,) training-target std (clamped)
    best: torch.Tensor,  # (J,) best observed cost
    mask: torch.Tensor,  # (J, m) bool candidate mask; False → EI = -inf
    xi: float = 0.0,
) -> torch.Tensor:
    """Masked EI over the m candidate columns of ``d2``; (J, m) float32."""
    k_star = matern52_from_sqdist(d2, ls[..., None, None]) * pm[..., :, None]
    mean_n = (k_star.transpose(-1, -2) @ alpha[..., None])[..., 0]
    v = torch.linalg.solve_triangular(chol, k_star, upper=False)
    var_n = torch.clamp_min(1.0 - torch.sum(v * v, -2), 1e-12)
    std_n = torch.sqrt(var_n)

    # De-standardize.
    mean = mean_n * y_std[..., None] + y_mean[..., None]
    std = std_n * y_std[..., None]

    improvement = best[..., None] - mean - xi
    z = improvement / torch.clamp_min(std, 1e-12)
    cdf = 0.5 * (1.0 + torch.special.erf(z / _SQRT2))
    pdf = torch.exp(-0.5 * z * z) / _SQRT2PI
    ei = torch.clamp_min(improvement * cdf + std * pdf, 0.0)
    return torch.where(mask, ei, -math.inf)
