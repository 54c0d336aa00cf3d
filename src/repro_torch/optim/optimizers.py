"""Optimizers as (init, update) pairs over parameter trees (port of
`repro/optim/optimizers.py`).

Two families, chosen per architecture by ``ExecConfig.optimizer``:

  * ``adamw``     — AdamW with f32 moments;
  * ``adafactor`` — factored second moment (row/column statistics over the
                    last two dims of ≥2-D tensors), no momentum, update-norm
                    clipping.

A tree is a nested dict/list of tensors (the port's parameter tree, layers
as a list).  ``update(params, state, grads, lr)`` updates the parameters and
the state's moments **in place**, under `torch.no_grad`, and returns them
with the new step: the reference returns new trees, which at full width
would be a second copy of every parameter and moment on the card.  The
arithmetic is the reference's, operation by operation, in float32: the bias
corrections and Adafactor's decay are float32 tensors on the parameters'
device (Python floats are float64), and Python constants take part as
float32, as JAX's weakly typed constants do.

``state_specs`` mirrors the `TensorSpec` tree of the parameters, as the
reference's does, so the state can be sized without allocating it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.spec import TensorSpec, flatten, tree_map

__all__ = [
    "OptState",
    "Optimizer",
    "adafactor",
    "adamw",
    "clip_by_global_norm",
    "global_norm",
    "make_optimizer",
]

_F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor  # scalar int32, on the parameters' device
    inner: Any  # optimizer-specific tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any, torch.Tensor], Tuple[Any, OptState]]
    # state_specs mirrors param TensorSpecs, as the reference's does.
    state_specs: Callable[[Any], Any]


def _with_state(params: Any, inner: Any) -> Iterator[Tuple[torch.Tensor, Any]]:
    """(parameter, its state) pairs in `flatten`'s order.  ``inner`` is AdamW's
    {"mu": tree, "nu": tree}, whose pair is (mu, nu), or Adafactor's tree
    with one state dict per parameter."""
    if isinstance(inner, dict) and set(inner) == {"mu", "nu"}:
        yield from zip(flatten(params), zip(flatten(inner["mu"]), flatten(inner["nu"])))
    elif isinstance(params, dict):
        for k, v in params.items():
            yield from _with_state(v, inner[k])
    elif isinstance(params, (list, tuple)):
        for v, s in zip(params, inner):
            yield from _with_state(v, s)
    else:
        yield params, inner


def _device(tree: Any) -> torch.device:
    flat = flatten(tree)
    return flat[0].device if flat else torch.device("cpu")


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ g²), in float32, the leaves summed in turn."""
    total = 0
    for x in flatten(tree):
        total = total + torch.sum(torch.square(x.to(_F32)))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` in place so that their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    limit = torch.tensor(max_norm, dtype=_F32, device=norm.device)
    scale = torch.clamp_max(limit / torch.clamp_min(norm, 1e-9), 1.0)
    for g in flatten(grads):
        if g.dtype == _F32:
            g.mul_(scale)
        else:  # the product in float32, as the reference promotes it, then back
            g.copy_(g.to(_F32) * scale)
    return grads, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(*, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params: Any) -> OptState:
        zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=_device(params)),
            inner={"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)},
        )

    @torch.no_grad()
    def update(params: Any, state: OptState, grads: Any, lr: torch.Tensor):
        step = state.step + 1
        stepf = step.to(_F32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=_F32, device=step.device), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=_F32, device=step.device), stepf)
        for (p, st), g in zip(_with_state(params, state.inner), flatten(grads)):
            mu, nu = st
            g = g.to(_F32)
            mu.mul_(b1).add_(g * (1 - b1))
            nu.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            denom = (nu / bc2).sqrt_().add_(eps)  # sqrt(nhat) + eps
            delta = (mu / bc1).div_(denom)  # mhat / (sqrt(nhat) + eps)
            del denom
            pf = p.to(_F32)  # p itself when p is float32
            delta.add_(weight_decay * pf).mul_(lr)
            p.copy_(pf - delta)
        return params, OptState(step=step, inner=state.inner)

    def state_specs(param_specs: Any) -> Any:
        f32 = lambda s: TensorSpec(s.shape, _F32, s.axes)
        return {"mu": tree_map(f32, param_specs), "nu": tree_map(f32, param_specs)}

    return Optimizer(init=init, update=update, state_specs=state_specs)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018) — factored second moment, no momentum
# ---------------------------------------------------------------------------


def _factored_dims(shape: Tuple[int, ...]) -> Optional[Tuple[int, int]]:
    """Last two non-trivial dims to factor over, or None for <2-D tensors."""
    if len(shape) < 2:
        return None
    return len(shape) - 2, len(shape) - 1


def adafactor(*, decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    def init(params: Any) -> OptState:
        def zero_state(p):
            dims = _factored_dims(tuple(p.shape))
            if dims is None:
                return {"v": torch.zeros(p.shape, dtype=_F32, device=p.device)}
            r, c = dims
            row_shape = tuple(d for i, d in enumerate(p.shape) if i != c)
            col_shape = tuple(d for i, d in enumerate(p.shape) if i != r)
            return {"vr": torch.zeros(row_shape, dtype=_F32, device=p.device),
                    "vc": torch.zeros(col_shape, dtype=_F32, device=p.device)}

        return OptState(step=torch.zeros((), dtype=torch.int32, device=_device(params)),
                        inner=tree_map(zero_state, params))

    @torch.no_grad()
    def update(params: Any, state: OptState, grads: Any, lr: torch.Tensor):
        step = state.step + 1
        # Step-dependent decay (Adafactor's \hat{beta2_t}).
        beta2t = 1.0 - torch.pow(step.to(_F32), torch.tensor(-decay, dtype=_F32,
                                                               device=step.device))
        for (p, st), g in zip(_with_state(params, state.inner), flatten(grads)):
            g = g.to(_F32)
            g2 = torch.square(g) + eps
            dims = _factored_dims(tuple(p.shape))
            if dims is None:
                v = st["v"]
                v.copy_(beta2t * v + (1 - beta2t) * g2)
                precond = g * torch.rsqrt(v + eps)
            else:
                r, c = dims
                vr, vc = st["vr"], st["vc"]
                vr.copy_(beta2t * vr + (1 - beta2t) * torch.mean(g2, dim=c))
                vc.copy_(beta2t * vc + (1 - beta2t) * torch.mean(g2, dim=r))
                row_mean = torch.mean(vr, dim=-1, keepdim=True)
                rfac = torch.rsqrt((vr / torch.clamp_min(row_mean, eps)).unsqueeze(c))
                cfac = torch.rsqrt(vc.unsqueeze(r))
                precond = g * rfac * cfac
            del g2
            # Update-norm clipping (RMS ≤ clip_threshold).
            rms = torch.sqrt(torch.mean(torch.square(precond)) + 1e-30)
            precond = precond / torch.clamp_min(rms / clip_threshold, 1.0)
            pf = p.to(_F32)
            p.copy_(pf - lr * (precond + weight_decay * pf))
        return params, OptState(step=step, inner=state.inner)

    def state_specs(param_specs: Any) -> Any:
        def spec_state(s: TensorSpec):
            dims = _factored_dims(s.shape)
            axes = s.axes if s.axes else (None,) * len(s.shape)
            if dims is None:
                return {"v": TensorSpec(s.shape, _F32, axes)}
            r, c = dims
            row_shape = tuple(d for i, d in enumerate(s.shape) if i != c)
            row_axes = tuple(a for i, a in enumerate(axes) if i != c)
            col_shape = tuple(d for i, d in enumerate(s.shape) if i != r)
            col_axes = tuple(a for i, a in enumerate(axes) if i != r)
            return {"vr": TensorSpec(row_shape, _F32, row_axes),
                    "vc": TensorSpec(col_shape, _F32, col_axes)}

        return tree_map(spec_state, param_specs)

    return Optimizer(init=init, update=update, state_specs=state_specs)


def make_optimizer(name: str, *, weight_decay: float = 0.01) -> Optimizer:
    if name == "adamw":
        return adamw(weight_decay=weight_decay)
    if name == "adafactor":
        return adafactor(weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")
