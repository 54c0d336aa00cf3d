"""Move the reference's parameter values (`params_from_jax`) and optimizer
state (`opt_state_from_jax`) into the port.

The reference keeps a nested dict with every stack of blocks stacked along
a leading "layers" axis (`models.model.STACKS`): ``layers`` (the decoder,
or the SSM family's layers), ``encoder.layers`` (encdec) and
``hybrid.mamba`` (hybrid).  The port keeps one dict per layer.  The rest
(``embed``, ``pos_table``, ``final_norm``, ``encoder.final_norm``, the
hybrid's one ``shared_attn`` block) is taken as it is.  The MoE's expert leaves keep their expert axis
after the layer axis.  Values are taken as they are (numpy arrays, or
anything `numpy.asarray` reads, such as JAX arrays); bfloat16 arrays go
through float32, which holds them exactly.

The optimizer state follows the port's optimizers: AdamW's moments are
split per layer as the parameters are, and Adafactor's state is kept
stacked, as the port's Adafactor holds it (`optim.optimizers`).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import STACKS
from repro_torch.models.spec import leaves, tree_map
from repro_torch.optim import OptState

__all__ = ["opt_state_from_jax", "params_from_jax"]


def _tensor(a: Any) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _unstack(tree: Any, n: int, where: str) -> List[Any]:
    stacked = tree_map(_tensor, tree)
    for name, leaf in leaves(stacked):
        if leaf.shape[0] != n:
            raise ValueError(f"{where}.{name}: stacked axis {leaf.shape[0]} != {n} layers")
    return [tree_map(lambda x, i=i: x[i].clone(), stacked) for i in range(n)]


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameter tree (CPU tensors) for the reference's ``tree``
    of a model of any family: each stacked group of `STACKS` split into its
    per-layer dicts, everything else as it is.  `models.model.Model` checks
    the names and shapes when it takes the tree."""

    def walk(value: Any, path: tuple) -> Any:
        if path in STACKS:
            n = cfg.encoder.num_layers if path[0] == "encoder" else cfg.num_layers
            return _unstack(value, n, ".".join(path))
        if isinstance(value, dict):
            return {k: walk(v, path + (k,)) for k, v in value.items()}
        return _tensor(value)

    return walk(tree, ())


def opt_state_from_jax(state: Any, cfg: ModelConfig) -> OptState:
    """The port's `OptState` (CPU tensors) for the reference's ``state``
    (its ``OptState``, or any (step, inner) pair) of a model of ``cfg``:
    AdamW's ``mu`` and ``nu`` split per layer as `params_from_jax` splits
    the parameters, Adafactor's stacked state as it is."""
    step, inner = state
    if isinstance(inner, dict) and set(inner) == {"mu", "nu"}:
        inner = {k: params_from_jax(v, cfg) for k, v in inner.items()}
    else:
        inner = tree_map(_tensor, inner)
    return OptState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32), inner=inner)
