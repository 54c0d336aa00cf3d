"""Move the reference's parameter values into the port (`params_from_jax`).

The reference keeps a nested dict with every block parameter stacked along
a leading "layers" axis; the port keeps one dict per layer.  Values are
taken as they are (numpy arrays, or anything `numpy.asarray` reads, such as
JAX arrays); bfloat16 arrays go through float32, which holds them exactly.
"""

from __future__ import annotations

from typing import Any, Dict

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


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameter tree (CPU tensors) for the reference's ``tree``
    of a dense or SSM model: ``embed`` and ``final_norm`` as they are,
    ``layers`` (``attn``/``mlp`` blocks, or ``norm``/``ssm``) split into
    ``cfg.num_layers`` per-layer dicts.  `models.model.Model` checks the
    names and shapes when it takes the tree."""
    n = cfg.num_layers
    stacked = tree_map(_tensor, tree["layers"])
    for name, leaf in leaves(stacked):
        if leaf.shape[0] != n:
            raise ValueError(f"layers.{name}: stacked axis {leaf.shape[0]} != num_layers {n}")
    return {
        "embed": tree_map(_tensor, tree["embed"]),
        "layers": [tree_map(lambda x, i=i: x[i].clone(), stacked) for i in range(n)],
        "final_norm": tree_map(_tensor, tree["final_norm"]),
    }
