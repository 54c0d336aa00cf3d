"""Gaussian-process regression in PyTorch (port of `repro/core/gp.py`).

The surrogate of the CherryPick-style Bayesian optimization Ruya builds
on: a Matérn-5/2 kernel over the encoded configuration features,
observation noise, and a Cholesky-based posterior.  Hyperparameters
(lengthscale, noise) are picked by log marginal likelihood over the same
deterministic 18-point grid as the reference.

Everything runs in float32 on the device of the input tensors: the
reference runs with JAX's 64-bit mode off, so its widest float is float32
too.  Functions broadcast over leading batch axes where the reference
would `vmap`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

__all__ = [
    "GPParams",
    "GPPosterior",
    "matern52",
    "matern52_from_sqdist",
    "pairwise_sqdist",
    "fit_gp",
    "gp_predict",
]

_JITTER = 1e-8
_SQRT5 = math.sqrt(5.0)
LENGTHSCALES = (0.1, 0.25, 0.5, 1.0, 2.0, 4.0)
NOISES = (1e-4, 1e-2, 1e-1)


@dataclasses.dataclass(frozen=True)
class GPParams:
    """Kernel hyperparameters (0-d tensors)."""

    lengthscale: torch.Tensor
    amplitude: torch.Tensor
    noise: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GPPosterior:
    """Cached posterior factorization for prediction."""

    params: GPParams
    x_train: torch.Tensor  # (n, d) features
    chol: torch.Tensor  # (n, n) lower Cholesky of K + noise*I
    alpha: torch.Tensor  # (n,) K^{-1} (y - mean) / std
    y_mean: torch.Tensor  # () standardization mean of y
    y_std: torch.Tensor  # () standardization scale of y


def pairwise_sqdist(x1: torch.Tensor, x2: torch.Tensor = None) -> torch.Tensor:
    """Raw pairwise squared distances between (..., n, d) and (..., m, d).

    The reference's expansion, op for op: sum of squares per row, one
    matmul for the cross terms, clamp at zero (the expansion can go
    slightly negative in float32).
    """
    if x2 is None:
        x2 = x1
    d2 = (
        torch.sum(x1 * x1, -1)[..., :, None]
        + torch.sum(x2 * x2, -1)[..., None, :]
        - 2.0 * x1 @ x2.transpose(-1, -2)
    )
    return torch.clamp_min(d2, 0.0)


def matern52_from_sqdist(
    d2: torch.Tensor, lengthscale, amplitude=1.0
) -> torch.Tensor:
    """Matérn-5/2 from raw squared distances, scalar (broadcast) lengthscale."""
    s2 = torch.clamp_min(d2 / (lengthscale * lengthscale), 1e-12)
    sqrt5_d = _SQRT5 * torch.sqrt(s2)
    return amplitude * (1.0 + sqrt5_d + 5.0 / 3.0 * s2) * torch.exp(-sqrt5_d)


def matern52(x1: torch.Tensor, x2: torch.Tensor, params: GPParams) -> torch.Tensor:
    """Matérn-5/2 kernel matrix between (n,d) and (m,d)."""
    scaled1 = x1 / params.lengthscale
    scaled2 = x2 / params.lengthscale
    d2 = (
        torch.sum(scaled1 * scaled1, -1)[:, None]
        + torch.sum(scaled2 * scaled2, -1)[None, :]
        - 2.0 * scaled1 @ scaled2.T
    )
    d = torch.sqrt(torch.clamp_min(d2, 1e-12))
    sqrt5_d = _SQRT5 * d
    return params.amplitude * (1.0 + sqrt5_d + 5.0 / 3.0 * d * d) * torch.exp(-sqrt5_d)


def candidate_grid(device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (18,) lengthscale and noise grids, lengthscale-major."""
    ls = torch.tensor(LENGTHSCALES, dtype=torch.float32, device=device)
    nz = torch.tensor(NOISES, dtype=torch.float32, device=device)
    return ls.repeat_interleave(len(NOISES)), nz.repeat(len(LENGTHSCALES))


def fit_gp(x: torch.Tensor, y: torch.Tensor) -> GPPosterior:
    """Fit a GP to (n, d) encoded features and (n,) raw costs.

    Targets are standardized internally.  A grid point whose Cholesky
    fails scores -inf, as the reference's NaN factor does.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    y_mean = torch.mean(y)
    y_std = torch.clamp_min(torch.std(y, correction=0), 1e-8)
    y_n = (y - y_mean) / y_std

    ls_grid, nz_grid = candidate_grid(x.device)
    n = x.shape[0]
    d2 = pairwise_sqdist(x)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    k = matern52_from_sqdist(d2, ls_grid[:, None, None]) + (
        nz_grid[:, None, None] + _JITTER
    ) * eye
    chol, info = torch.linalg.cholesky_ex(k)
    alpha = torch.cholesky_solve(y_n.expand(len(ls_grid), n)[..., None], chol)[..., 0]
    lml = (
        -0.5 * torch.sum(y_n * alpha, -1)
        - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)
        - 0.5 * n * math.log(2.0 * math.pi)
    )
    lml = torch.where((info == 0) & torch.isfinite(lml), lml, -math.inf)
    best = int(torch.argmax(lml))
    params = GPParams(
        lengthscale=ls_grid[best],
        amplitude=torch.ones((), dtype=x.dtype, device=x.device),
        noise=nz_grid[best],
    )
    return GPPosterior(
        params=params, x_train=x, chol=chol[best], alpha=alpha[best],
        y_mean=y_mean, y_std=y_std,
    )


def gp_predict(post: GPPosterior, x_new: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and standard deviation at ``x_new`` (m, d), raw y units."""
    x_new = torch.as_tensor(x_new, dtype=post.x_train.dtype, device=post.x_train.device)
    k_star = matern52(post.x_train, x_new, post.params)  # (n, m)
    mean_n = k_star.T @ post.alpha
    v = torch.linalg.solve_triangular(post.chol, k_star, upper=False)
    var_n = torch.clamp_min(post.params.amplitude - torch.sum(v * v, 0), 1e-12)
    return mean_n * post.y_std + post.y_mean, torch.sqrt(var_n) * post.y_std
