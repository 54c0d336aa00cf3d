"""Move the reference's parameter values into the port (`params_from_jax`).

The reference keeps a nested dict with every stack of blocks stacked along
a leading "layers" axis: ``layers`` (the decoder, or the SSM family's
layers), ``encoder.layers`` (encdec) and ``hybrid.mamba`` (hybrid).  The
port keeps one dict per layer.  The rest (``embed``, ``pos_table``,
``final_norm``, ``encoder.final_norm``, the hybrid's one ``shared_attn``
block) is taken as it is.  The MoE's expert leaves keep their expert axis
after the layer axis.  Values are taken as they are (numpy arrays, or
anything `numpy.asarray` reads, such as JAX arrays); bfloat16 arrays go
through float32, which holds them exactly.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import leaves, tree_map

__all__ = ["params_from_jax"]


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
    of a model of any family: each stacked group split into its per-layer
    dicts, everything else as it is.  `models.model.Model` checks the names
    and shapes when it takes the tree."""
    out: Dict[str, Any] = {}
    for group, value in tree.items():
        if group == "layers":
            out[group] = _unstack(value, cfg.num_layers, group)
        elif group == "encoder":
            out[group] = {"layers": _unstack(value["layers"], cfg.encoder.num_layers,
                                             "encoder.layers"),
                          "final_norm": tree_map(_tensor, value["final_norm"])}
        elif group == "hybrid":
            out[group] = {"mamba": _unstack(value["mamba"], cfg.num_layers, "hybrid.mamba"),
                          "shared_attn": tree_map(_tensor, value["shared_attn"])}
        else:
            out[group] = tree_map(_tensor, value)
    return out
