"""Step-function factories (port of `repro/runtime/steps.py`): the training
step and the serving pair.

``train_step(state, batch) -> (state, metrics)`` over ``TrainState =
{"params": tree, "opt": OptState}``, where the tree is the model's own
parameters (`Model.params_tree`, layers as a list), and
``prefill_step(params, batch, cache)`` / ``decode_step(params, cache,
tokens, index)`` keep the reference's signatures.

A training step runs the reference's sequence: loss → gradients (autograd
through `Model.loss_fn`, each layer under the config's remat policy) →
bf16 cast of each microbatch's float32 gradients (``bf16_grad_reduce``;
the reference casts inside its per-microbatch grad fn so that its
cross-device reduction moves half the bytes, and on one device the cast
still decides where the sum rounds) → accumulation over microbatches →
float32 → global-norm clipping → learning-rate schedule → AdamW or
Adafactor update.  Its metrics are the reference's: loss, ce, z_loss,
aux_loss, tokens (the microbatches' mean), grad_norm and lr, all tensors on
the model's device: the step itself never waits for the card.

The update is in place: the state's parameters are the model's tensors,
and the returned state holds the same tensors with the new values.  Over
DTensors (`launch.build`) the model reads its parameters through
`parallel.spmd.gathered`, each FSDP-sharded weight gathered where it is
used and its gradient reduce-scattered back onto the shards.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ExecConfig
from repro_torch.models.model import STACKS, Model
from repro_torch.models.spec import TensorSpec, flatten, unflatten
from repro_torch.optim import OptState, clip_by_global_norm, linear_warmup_cosine, make_optimizer
from repro_torch.parallel import spmd
from repro_torch.parallel.microbatch import accumulate_gradients
from repro_torch.spans import OPTIM_UPDATE, TRAIN_GRADS, span

__all__ = ["TrainState", "init_train_state", "make_grad_fn", "make_serve_steps",
           "make_train_step", "train_state_specs"]

TrainState = Dict[str, Any]  # {"params": tree, "opt": OptState}


def _optimizer(exec_cfg: ExecConfig):
    """The config's optimizer over the model's tree, its stacks named."""
    return make_optimizer(exec_cfg.optimizer, weight_decay=exec_cfg.weight_decay, stacks=STACKS)


def make_grad_fn(model: Model, exec_cfg: ExecConfig) -> Callable[[Any, Dict[str, Any]],
                                                                  Tuple[Any, Dict]]:
    """The training step's first half, ``(params, batch) -> (grads, metrics)``:
    the float32 gradients after accumulation and clipping, and the metrics
    with ``grad_norm`` (the norm before clipping).  It updates nothing."""
    accum_dtype = getattr(torch, exec_cfg.accum_dtype) if exec_cfg.accum_dtype else None

    def micro_grads(params, mb):
        flat = flatten(params)
        with torch.enable_grad():
            for p in flat:
                p.requires_grad_(True)
            loss, metrics = model.loss_fn(mb, params=spmd.gathered(params))
            grads = list(torch.autograd.grad(loss, flat))
        if exec_cfg.bf16_grad_reduce:
            with span(TRAIN_GRADS):
                for i, g in enumerate(grads):  # leaf by leaf: one float32 copy dropped at a time
                    if g.dtype == torch.float32:
                        grads[i] = g.to(torch.bfloat16)
        return unflatten(params, grads), {k: v.detach() for k, v in metrics.items()}

    def grad_fn(params, batch):
        grads, metrics = accumulate_gradients(micro_grads, params, batch,
                                              exec_cfg.num_microbatches,
                                              accum_dtype=accum_dtype)
        with span(TRAIN_GRADS):
            flat = flatten(grads)
            del grads
            for i, g in enumerate(flat):
                flat[i] = g.to(torch.float32)
            grads, grad_norm = clip_by_global_norm(unflatten(params, flat), exec_cfg.grad_clip)
        return grads, dict(metrics, grad_norm=grad_norm)

    return grad_fn


def make_train_step(model: Model, exec_cfg: ExecConfig
                    ) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict]]:
    """The training step for (model, exec config)."""
    optimizer = _optimizer(exec_cfg)
    grad_fn = make_grad_fn(model, exec_cfg)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params, opt = state["params"], state["opt"]
        grads, metrics = grad_fn(params, batch)
        with span(OPTIM_UPDATE):
            lr = linear_warmup_cosine(opt.step + 1, exec_cfg.learning_rate,
                                      exec_cfg.warmup_steps, exec_cfg.total_steps)
            params, opt = optimizer.update(params, opt, grads, lr)
        metrics["lr"] = lr
        return {"params": params, "opt": opt}, metrics

    return train_step


def init_train_state(model: Model, exec_cfg: ExecConfig) -> TrainState:
    """The model's parameters (set to require gradients) and a fresh optimizer
    state.  The reference draws the parameters here from a key; the port's
    `Model` has drawn them already, from its ``seed``.  AdamW's moments
    follow the port's tree (a list per stack); Adafactor's state is the
    reference's, stacked over layers, as `train_state_specs` gives it."""
    optimizer = _optimizer(exec_cfg)
    params = model.params_tree()
    for p in flatten(params):
        p.requires_grad_(True)
    return {"params": params, "opt": optimizer.init(params)}


def train_state_specs(model: Model, exec_cfg: ExecConfig, *, per_layer: bool = False) -> Any:
    """TensorSpec tree matching the reference's ``init_train_state`` (the
    parameters stacked over layers, as `Model.param_specs` gives them).
    Adafactor's state is allocated in this layout; the parameters and
    AdamW's moments are its per-layer slices.  ``per_layer=True`` gives the
    tree `init_train_state` holds: the parameters and AdamW's moments a list
    per stack, each layer's spec its stack's without the layer axis."""
    optimizer = _optimizer(exec_cfg)
    pspecs = model.param_specs()
    params = model.param_specs(stacked=False) if per_layer else pspecs
    inner = optimizer.state_specs(params if exec_cfg.optimizer == "adamw" else pspecs)
    return {"params": params,
            "opt": OptState(step=TensorSpec((), torch.int32, ()), inner=inner)}


def make_serve_steps(model: Model):
    """(prefill_step, decode_step) pair for the serving path."""

    def prefill_step(params, batch, cache):
        return model.prefill(batch, cache, params=spmd.gathered(params))

    def decode_step(params, cache, tokens, index):
        return model.decode_step(cache, tokens, index, params=spmd.gathered(params))

    return prefill_step, decode_step
