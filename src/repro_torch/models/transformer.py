"""Decoder-only transformer stack (port of `repro/models/transformer.py`, dense blocks).

The reference stacks per-layer parameters along a leading "layers" axis
and scans one compiled body over it.  The port keeps the stacked spec tree
(`decoder_stack_specs`, for parameter accounting and for comparing names
with the reference) but holds the layers apart, as a list of per-layer
dicts, and runs them in a Python loop (`decoder_stack_apply`).  Where the
reference wraps its scan body in `remat_wrap(body, cfg.remat_policy)`, the
port wraps each layer's call, when gradients are enabled (training): a
forward or a prefill under `torch.no_grad` saves nothing to recompute.
MoE blocks and the encoder stack come with ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import TensorSpec, tree_map
from repro_torch.parallel.remat import remat_wrap

__all__ = ["block_apply", "block_specs", "decoder_stack_apply", "decoder_stack_specs",
           "stack_specs"]


def stack_specs(tree: Any, n: int) -> Any:
    """Prepend a stacked "layers" axis of size ``n`` to every spec leaf."""

    def stack(s: TensorSpec) -> TensorSpec:
        axes = s.axes if s.axes else (None,) * len(s.shape)
        return TensorSpec((n,) + s.shape, s.dtype, ("layers",) + tuple(axes),
                          init=s.init, init_scale=s.init_scale)

    return tree_map(stack, tree)


def block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.family == "moe":
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP Queue 1 item 11)")
    return {
        "attn_norm": L.norm_specs(cfg),
        "attn": L.attn_specs(cfg),
        "mlp_norm": L.norm_specs(cfg),
        "mlp": L.mlp_specs(cfg),
    }


def block_apply(
    p: Dict[str, Any],
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    use_rope: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Pre-norm dense block.  Returns (x, aux_loss, cache)."""
    h = L.norm_apply(p["attn_norm"], cfg, x)
    attn_out, cache = L.attn_apply(p["attn"], cfg, h, positions=positions, causal=causal,
                                   cache=cache, cache_index=cache_index, use_rope=use_rope)
    x = x + attn_out
    h = L.norm_apply(p["mlp_norm"], cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + L.mlp_apply(p["mlp"], cfg, h), aux, cache


def decoder_stack_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return stack_specs(block_specs(cfg), cfg.num_layers)


def decoder_stack_apply(
    layers: List[Dict[str, Any]],
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    caches: Optional[Dict[str, torch.Tensor]] = None,  # stacked {"k","v"}
    cache_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Run the blocks in order.  Each layer writes its slice of the stacked
    caches in place.  Returns (hidden, total aux loss, caches or None)."""
    def body(p, x, cache):
        x, a, _ = block_apply(p, cfg, x, positions=positions, cache=cache,
                              cache_index=cache_index, use_rope=cfg.pos_emb == "rope")
        return x, a

    if torch.is_grad_enabled():
        body = remat_wrap(body, cfg.remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(layers):
        cache = None if caches is None else {"k": caches["k"][i], "v": caches["v"][i]}
        x, a = body(p, x, cache)
        aux = aux + a
    return x, aux, caches
