"""Optimizers as (init, update) pairs over parameter trees (port of
`repro/optim/optimizers.py`).

Two families, chosen per architecture by ``ExecConfig.optimizer``:

  * ``adamw``     — AdamW with f32 moments;
  * ``adafactor`` — factored second moment (row/column statistics over the
                    last two dims of ≥2-D leaves), no momentum, update-norm
                    clipping per leaf.

A tree is a nested dict/list of tensors (the port's parameter tree, layers
as a list).  ``update(params, state, grads, lr)`` updates the parameters and
the state's moments **in place**, under `torch.no_grad`, and returns them
with the new step: the reference returns new trees, which at full width
would be a second copy of every parameter and moment on the card.  The
arithmetic is the reference's, operation by operation, in float32: the bias
corrections and Adafactor's decay are float32 tensors on the parameters'
device (Python floats are float64), and Python constants take part as
float32, as JAX's weakly typed constants do.

Adafactor is not elementwise: it factors the second moment over a leaf's
last two dims and clips the update by the RMS of the whole leaf, and the
reference's leaves hold each stack of blocks stacked along a leading layer
axis.  So ``adafactor(stacks=...)`` (from `runtime.steps`: `models.model.
STACKS`) computes the reference's function of the stacked tree, and holds
the reference's stacked state (``vr``/``vc``/``v`` shaped as over the
stacked leaf, so that `init` and `state_specs` agree and a checkpoint has
the reference's layout).  For a stack of L per-layer tensors of shape s:

  * rank(s) ≥ 2: row l of ``vr``/``vc`` is layer l's statistics, and the
    clip's RMS is one value over all L layers' updates.  Two passes over
    the layers: the first folds g² into the state and sums the squares of
    the preconditioned update, the second recomputes the update (the same
    float32 operations on the same values) and applies it.  One layer's
    float32 temporaries are live at a time, never a second copy of the
    stack; the cost is the preconditioner computed twice;
  * rank(s) ≤ 1 (norm scales, biases, the SSM's A_log, D, dt_bias): the
    stacked (L, d) leaf is factored over layers and channels (``vr`` is
    (L,), ``vc`` is (d,)), so every layer's update depends on every
    layer's gradient: these small leaves are stacked whole, updated as the
    reference's leaf, and copied back row by row.

``state_specs`` mirrors the `TensorSpec` tree of the parameters, as the
reference's does, so the state can be sized without allocating it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, NamedTuple, Optional, Sequence, Tuple

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


def _precond(g: torch.Tensor, st: dict, beta2t: torch.Tensor, eps: float,
             update: bool) -> torch.Tensor:
    """The preconditioned update of one tensor ``g`` (float32) from its
    state ``st`` (``v``, or ``vr``/``vc`` over the last two dims), after
    folding g² into the state in place when ``update``."""
    if "v" in st:
        v = st["v"]
        if update:
            v.copy_(beta2t * v + (1 - beta2t) * (torch.square(g) + eps))
        return g * torch.rsqrt(v + eps)
    r, c = g.dim() - 2, g.dim() - 1
    vr, vc = st["vr"], st["vc"]
    if update:
        g2 = torch.square(g) + eps
        vr.copy_(beta2t * vr + (1 - beta2t) * torch.mean(g2, dim=c))
        vc.copy_(beta2t * vc + (1 - beta2t) * torch.mean(g2, dim=r))
        del g2
    row_mean = torch.mean(vr, dim=-1, keepdim=True)
    rfac = torch.rsqrt((vr / torch.clamp_min(row_mean, eps)).unsqueeze(c))
    return g * rfac * torch.rsqrt(vc.unsqueeze(r))


def _units(params: Any, grads: Any, inner: Any, stacks: Sequence[Tuple[str, ...]],
           path: Tuple[str, ...] = ()) -> Iterator[Tuple[list, list, dict, bool]]:
    """Adafactor's units, in `flatten`'s order of the parameters: (the
    per-layer tensors of one reference leaf, their gradients, its stacked
    state, True) for each leaf of a stack, (tensor, gradient, state, False)
    for every other leaf."""
    if path in stacks:
        layers_p = [flatten(p) for p in params]
        layers_g = [flatten(g) for g in grads]
        for i, (_, st) in enumerate(_with_state(params[0], inner)):
            yield [p[i] for p in layers_p], [g[i] for g in layers_g], st, True
    elif isinstance(params, dict):
        for k, v in params.items():
            yield from _units(v, grads[k], inner[k], stacks, path + (k,))
    elif isinstance(params, (list, tuple)):
        for v, g, s in zip(params, grads, inner):
            yield from _units(v, g, s, stacks, path + (None,))
    else:
        yield [params], [grads], inner, False


def adafactor(*, stacks: Sequence[Tuple[str, ...]], decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0) -> Optimizer:
    """Adafactor over the reference's tree: each path in ``stacks`` names a
    list of per-layer dicts that the reference holds as one leaf per
    parameter, stacked along a leading layer axis, and is factored and
    clipped as that leaf (see the module docstring).  ``stacks`` is ``()``
    only for a tree with no per-layer lists."""
    stacks = tuple(tuple(s) for s in stacks)

    def zero_state(shape, device):
        dims = _factored_dims(shape)
        if dims is None:
            return {"v": torch.zeros(shape, dtype=_F32, device=device)}
        r, c = dims
        row_shape = tuple(d for i, d in enumerate(shape) if i != c)
        col_shape = tuple(d for i, d in enumerate(shape) if i != r)
        return {"vr": torch.zeros(row_shape, dtype=_F32, device=device),
                "vc": torch.zeros(col_shape, dtype=_F32, device=device)}

    def init(params: Any) -> OptState:
        def walk(tree, path):
            if path in stacks:
                n = len(tree)
                return tree_map(lambda p: zero_state((n,) + tuple(p.shape), p.device), tree[0])
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(v, path + (None,)) for v in tree)
            return zero_state(tuple(tree.shape), tree.device)

        return OptState(step=torch.zeros((), dtype=torch.int32, device=_device(params)),
                        inner=walk(params, ()))

    def apply(slices, n: int, beta2t: torch.Tensor, lr: torch.Tensor) -> None:
        """Update the tensors of ``slices`` ((param, grad, state) that make
        up one reference leaf of ``n`` values) under one RMS clip: a first
        pass folds each g² into the state and sums the squares of the
        preconditioned update, a second recomputes the update and applies
        it (one slice keeps its update between the passes)."""
        keep = len(slices) == 1
        total, pre = 0, None
        for p, g, st in slices:
            pre = _precond(g.to(_F32), st, beta2t, eps, update=True)
            total = total + torch.sum(torch.square(pre))
            if not keep:
                pre = None
        # Update-norm clipping (RMS ≤ clip_threshold), over the whole leaf.
        rms = torch.sqrt(total / n + 1e-30)
        scale = torch.clamp_min(rms / clip_threshold, 1.0)
        for p, g, st in slices:
            if pre is None:
                pre = _precond(g.to(_F32), st, beta2t, eps, update=False)
            pre = pre / scale
            pf = p.to(_F32)
            p.copy_(pf - lr * (pre + weight_decay * pf))
            pre = None

    @torch.no_grad()
    def update(params: Any, state: OptState, grads: Any, lr: torch.Tensor):
        step = state.step + 1
        # Step-dependent decay (Adafactor's \hat{beta2_t}).
        beta2t = 1.0 - torch.pow(step.to(_F32), torch.tensor(-decay, dtype=_F32,
                                                               device=step.device))
        for ps, gs, st, stacked in _units(params, grads, state.inner, stacks):
            n = sum(p.numel() for p in ps)
            if not stacked:
                apply([(ps[0], gs[0], st)], n, beta2t, lr)
            elif ps[0].dim() >= 2:  # factored within each layer: one slice a layer
                apply([(p, g, {k: v[l] for k, v in st.items()})
                       for l, (p, g) in enumerate(zip(ps, gs))], n, beta2t, lr)
            else:  # an (L,) or (L, d) leaf, factored over the layers: stacked whole
                whole = torch.stack(ps)
                apply([(whole, torch.stack([g.to(_F32) for g in gs]), st)], n, beta2t, lr)
                for l, p in enumerate(ps):
                    p.copy_(whole[l])
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


def make_optimizer(name: str, *, stacks: Sequence[Tuple[str, ...]],
                   weight_decay: float = 0.01) -> Optimizer:
    """The optimizer ``name``; ``stacks`` names the tree's per-layer stacks
    (`models.model.STACKS`, or ``()`` for a tree with none), which Adafactor
    factors and clips as the reference's stacked leaves (AdamW is
    elementwise: stacking changes nothing for it)."""
    if name == "adamw":
        return adamw(weight_decay=weight_decay)
    if name == "adafactor":
        return adafactor(weight_decay=weight_decay, stacks=stacks)
    raise ValueError(f"unknown optimizer {name!r}")
