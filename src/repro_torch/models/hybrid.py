"""Zamba2-style hybrid stack (port of `repro/models/hybrid.py`): Mamba-2
layers and one weight-shared attention+MLP block applied every
``cfg.hybrid_attn_every`` layers.

The shared block (one parameter copy) fires before the SSM layer at layers
0, every, 2·every, ...; each firing site has its own KV cache at decode
time (``ak`` / ``av``, indexed by ``layer // every``), since the
activations differ per depth.  Zamba2's per-site LoRA adapters are left
out, as in the reference.

The reference scans one body over the stacked Mamba layers with a
`lax.cond` for the shared block; the port loops over the layers in Python
and calls the block only at its sites, so no other layer touches the site
caches.  Each layer writes its slice of the stacked SSM state, and each
site its cache, in place.  As in `Model`'s SSM family, every chunked SSD
call takes the SSD kernel (``use_kernel=True``; the reference's hybrid
takes the einsum route, which computes the same function); decode
(T = 1) is the recurrent step, which has no kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import TensorSpec
from repro_torch.models.transformer import stack_specs
from repro_torch.parallel.remat import remat_wrap

__all__ = ["hybrid_apply", "hybrid_specs", "hybrid_state_specs", "num_attn_sites"]

State = Dict[str, torch.Tensor]


def num_attn_sites(cfg: ModelConfig) -> int:
    if cfg.hybrid_attn_every <= 0:
        raise ValueError("the hybrid family needs hybrid_attn_every > 0")
    return math.ceil(cfg.num_layers / cfg.hybrid_attn_every)


def _mamba_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"norm": L.norm_specs(cfg), "ssm": S.ssm_specs(cfg)}


def hybrid_specs(cfg: ModelConfig, *, stacked: bool = True) -> Dict[str, Any]:
    """``mamba`` stacked as the reference's (or with ``stacked=False`` as
    the port holds it, a list of per-layer dicts) and the one
    ``shared_attn`` block."""
    mamba = (stack_specs(_mamba_layer_specs(cfg), cfg.num_layers) if stacked
             else [_mamba_layer_specs(cfg) for _ in range(cfg.num_layers)])
    return {
        "mamba": mamba,
        "shared_attn": {
            "attn_norm": L.norm_specs(cfg),
            "attn": L.attn_specs(cfg),
            "mlp_norm": L.norm_specs(cfg),
            "mlp": L.mlp_specs(cfg),
        },
    }


def hybrid_state_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, TensorSpec]:
    """Decode state: per-layer SSM states and per-site KV caches."""
    ssm_state = S.ssm_state_specs(cfg, batch, cfg.num_layers)
    shape = (num_attn_sites(cfg), batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    return {
        "ssd": ssm_state["ssd"],
        "conv": ssm_state["conv"],
        "ak": TensorSpec(shape, cfg.cdtype, axes),
        "av": TensorSpec(shape, cfg.cdtype, axes),
    }


def _shared_attn_block(p: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, cache: Optional[State],
                       cache_index: Optional[int]) -> torch.Tensor:
    h = L.norm_apply(p["attn_norm"], cfg, x)
    attn_out, _ = L.attn_apply(p["attn"], cfg, h, positions=positions, causal=True,
                               cache=cache, cache_index=cache_index)
    x = x + attn_out
    h = L.norm_apply(p["mlp_norm"], cfg, x)
    return x + L.mlp_apply(p["mlp"], cfg, h)


def hybrid_apply(
    params: Dict[str, Any],  # {"mamba": [per-layer dicts], "shared_attn": dict}
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, T, d) embedded inputs
    *,
    positions: torch.Tensor,
    state: Optional[State] = None,
    cache_index: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """Run the hybrid stack.  Returns (hidden, state or None).

    Modes: teacher-forced (state=None), prefill (a zeroed state, index 0),
    decode (a filled state, T = 1).  The state is updated in place.
    """
    every = cfg.hybrid_attn_every
    shared = params["shared_attn"]

    def body(i: int, p: Dict[str, Any], h: torch.Tensor) -> Tuple[torch.Tensor, Optional[State]]:
        if i % every == 0:
            site = i // every
            cache = None if state is None else {"k": state["ak"][site], "v": state["av"][site]}
            h = _shared_attn_block(shared, cfg, h, positions, cache, cache_index)
        hn = L.norm_apply(p["norm"], cfg, h)
        layer_state = None if state is None else {"ssd": state["ssd"][i],
                                                  "conv": state["conv"][i]}
        out, new = S.ssm_apply(p["ssm"], cfg, hn, state=layer_state, use_kernel=True)
        return h + out, new

    if torch.is_grad_enabled():  # training: the reference's remat_wrap(body, ...)
        body = remat_wrap(body, cfg.remat_policy)
    layers: List[Dict[str, Any]] = params["mamba"]
    for i, p in enumerate(layers):
        x, new = body(i, p, x)
        if state is not None:
            state["ssd"][i].copy_(new["ssd"])
            state["conv"][i].copy_(new["conv"])
    return x, state
