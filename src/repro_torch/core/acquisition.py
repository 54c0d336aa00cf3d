"""Acquisition functions (port of `repro/core/acquisition.py`).

CherryPick, and hence Ruya, uses Expected Improvement: the next
configuration to try is the one believed to save the most cost over the
best one seen so far.  Probability of Improvement is the other
acquisition the paper names.
"""

from __future__ import annotations

import math

import torch

__all__ = ["expected_improvement", "probability_of_improvement"]

_SQRT2 = math.sqrt(2.0)
_SQRT2PI = math.sqrt(2.0 * math.pi)


def _norm_pdf(z: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * z * z) / _SQRT2PI


def _norm_cdf(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.special.erf(z / _SQRT2))


def expected_improvement(mean, std, best, xi: float = 0.0) -> torch.Tensor:
    """EI for cost *minimization*: E[max(best - f, 0)]."""
    std = torch.clamp_min(std, 1e-12)
    improvement = best - mean - xi
    z = improvement / std
    return torch.clamp_min(improvement * _norm_cdf(z) + std * _norm_pdf(z), 0.0)


def probability_of_improvement(mean, std, best, xi: float = 0.0) -> torch.Tensor:
    """P[f < best - xi] under the GP posterior (cost minimization)."""
    std = torch.clamp_min(std, 1e-12)
    return _norm_cdf((best - mean - xi) / std)
