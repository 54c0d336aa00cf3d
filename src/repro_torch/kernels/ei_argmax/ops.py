"""Fused EI/argmax dispatch: the CUDA kernel on the card, the plain version on the CPU.

Port of `repro/kernels/ei_argmax/ops.py`.  `ei_argmax` returns the
(argmax index, max EI) pair over the masked candidates without the caller
ever holding the (B,n) cross block:

  * a CUDA tensor launches the hand-written kernel (`kernel.ei_argmax_cuda`)
    or raises;
  * a CPU tensor takes `ei_argmax_plain`, the twin of the reference's
    `_ei_argmax_scan`: a loop over candidate tiles through the shared tail
    (`tile.ei_from_sqdist`) with a strict-`>` running (max, argmax) fold.

The plain version pads n up to a tile multiple with the mask padded
False, so padded columns reach the fold as EI = -inf and never win; an
all-masked pool returns index 0, as `torch.argmax` over all -inf does.
It also takes a NaN tile maximum over a number (the reference's fold
keeps the number): EI is NaN only when every Cholesky of the head failed,
and then the fold agrees with `torch.argmax` over the full block, as the
kernel does, and so picks what the reference's feature layout picks (the
lowest unmasked index), where the reference's fused lane returns index 0.
The kernel handles the ragged edge itself and needs no padding.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.gp import pairwise_sqdist
from repro_torch.kernels.ei_argmax.kernel import ei_argmax_cuda
from repro_torch.kernels.ei_argmax.tile import ei_from_sqdist

__all__ = ["ei_argmax", "ei_argmax_plain"]

_DEFAULT_TILE = 1024
_MIN_TILE = 128


def _pick_tile(n: int, tile: Optional[int]) -> int:
    if tile is not None:
        t = int(tile)
        if t < 1:
            raise ValueError(f"tile must be positive, got {tile}")
        return t
    if n >= _DEFAULT_TILE:
        return _DEFAULT_TILE
    return -(-n // _MIN_TILE) * _MIN_TILE  # one tile, 128-aligned


def ei_argmax_plain(
    enc, mask, feats, pm, alpha, chol, ls, y_mean, y_std, best,
    *, xi: float = 0.0, tile: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, on any device: ((J,) int32, (J,) f32).

    ``tile`` sets the tile width (None: 1024, or one 128-aligned tile for
    small n); the pick does not depend on it.
    """
    J, n, d = enc.shape
    t = _pick_tile(n, tile)
    n_pad = -(-n // t) * t
    if n_pad != n:
        enc = torch.cat([enc, enc.new_zeros((J, n_pad - n, d))], 1)
        mask = torch.cat([mask, mask.new_zeros((J, n_pad - n))], 1)
    pm = pm.to(torch.float32)
    run_val = torch.full((J,), -math.inf, dtype=torch.float32, device=enc.device)
    run_idx = torch.zeros(J, dtype=torch.int32, device=enc.device)
    for off in range(0, n_pad, t):
        ei = ei_from_sqdist(
            pairwise_sqdist(feats, enc[:, off:off + t]), pm, alpha, chol,
            ls, y_mean, y_std, best, mask[:, off:off + t], xi,
        )
        tile_max = torch.amax(ei, -1)
        tile_idx = torch.argmax(ei, -1).to(torch.int32) + off
        # Strict >: an equal later tile never displaces the running winner.
        upd = (tile_max > run_val) | (torch.isnan(tile_max) & ~torch.isnan(run_val))
        run_val = torch.where(upd, tile_max, run_val)
        run_idx = torch.where(upd, tile_idx, run_idx)
    return run_idx, run_val


def ei_argmax(
    enc: torch.Tensor,  # (J, n, d) f32 static encoding of the space
    mask: torch.Tensor,  # (J, n) bool candidate mask (cand & ~obs)
    feats: torch.Tensor,  # (J, B, d) packed features of observed points
    pm: torch.Tensor,  # (J, B) packed-slot validity
    alpha: torch.Tensor,  # (J, B) K⁻¹ y_train, selected hyperparameters
    chol: torch.Tensor,  # (J, B, B) Cholesky of the masked training kernel
    ls: torch.Tensor,  # (J,) selected lengthscale
    y_mean: torch.Tensor,  # (J,) target mean
    y_std: torch.Tensor,  # (J,) target std
    best: torch.Tensor,  # (J,) best observed cost
    *,
    xi: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((J,) int32 argmax index, (J,) f32 max EI) over the masked candidates."""
    if enc.device.type == "cuda":
        f32 = torch.float32
        scal = torch.stack([ls, y_mean, y_std, best], -1).to(f32)
        return ei_argmax_cuda(
            enc.to(f32).contiguous(), mask.contiguous(), feats.to(f32).contiguous(),
            pm.to(f32).contiguous(), alpha.to(f32).contiguous(),
            chol.to(f32).contiguous(), scal.contiguous(), xi,
        )
    if enc.device.type != "cpu":
        raise ValueError(f"ei_argmax runs on cuda or cpu tensors, got {enc.device}")
    return ei_argmax_plain(
        enc, mask, feats, pm, alpha, chol, ls, y_mean, y_std, best, xi=xi,
    )
