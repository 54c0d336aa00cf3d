"""Transformer stacks (port of `repro/models/transformer.py`): the decoder
(dense or MoE blocks, with cross-attention for whisper) and whisper's
encoder.

The reference stacks per-layer parameters along a leading "layers" axis
and scans one compiled body over it.  The port keeps the stacked spec tree
(`decoder_stack_specs`, `encoder_stack_specs`, for parameter accounting and
for comparing names with the reference) but holds the layers apart, as a
list of per-layer dicts, and runs them in a Python loop.  Where the
reference wraps its scan body in `remat_wrap(body, cfg.remat_policy)`, the
port wraps each layer's call, when gradients are enabled (training): a
forward or a prefill under `torch.no_grad` saves nothing to recompute.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import TensorSpec, tree_map
from repro_torch.parallel import spmd
from repro_torch.parallel.constraints import shard_activation
from repro_torch.parallel.remat import remat_wrap

__all__ = ["block_apply", "block_specs", "decoder_stack_apply", "decoder_stack_specs",
           "encoder_stack_apply", "encoder_stack_specs", "sinusoidal_positions", "stack_specs"]

Cache = Dict[str, torch.Tensor]


def stack_specs(tree: Any, n: int) -> Any:
    """Prepend a stacked "layers" axis of size ``n`` to every spec leaf."""

    def stack(s: TensorSpec) -> TensorSpec:
        axes = s.axes if s.axes else (None,) * len(s.shape)
        return TensorSpec((n,) + s.shape, s.dtype, ("layers",) + tuple(axes),
                          init=s.init, init_scale=s.init_scale)

    return tree_map(stack, tree)


def _maybe_remat(body, cfg: ModelConfig):
    return remat_wrap(body, cfg.remat_policy) if torch.is_grad_enabled() else body


# ---------------------------------------------------------------------------
# One block (dense or MoE, optionally with cross-attention)
# ---------------------------------------------------------------------------


def block_specs(cfg: ModelConfig, *, cross: bool = False) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "attn_norm": L.norm_specs(cfg),
        "attn": L.attn_specs(cfg),
        "mlp_norm": L.norm_specs(cfg),
    }
    if cross:
        specs["cross_norm"] = L.norm_specs(cfg)
        specs["cross_attn"] = L.attn_specs(cfg, cross=True)
    if cfg.family == "moe":
        specs["moe"] = L.moe_specs(cfg)
    else:
        specs["mlp"] = L.mlp_specs(cfg)
    return specs


def _cross_from_cache(p: Dict[str, torch.Tensor], cfg: ModelConfig, h: torch.Tensor,
                      cache: Cache) -> torch.Tensor:
    """Cross-attention over the encoder K/V projected once at prefill: only
    the queries are projected here."""
    cd = cfg.cdtype
    q = spmd.project("btd,dhk->bthk", h, p["wq"].to(cd))
    if "bq" in p:
        q = q + p["bq"].to(cd)
    out = L._sdpa(q, cache["k"], cache["v"], causal=False)
    y = spmd.project("bthk,hkd->btd", out, p["wo"].to(cd))
    if "bo" in p:
        y = y + p["bo"].to(cd)
    return y


def block_apply(
    p: Dict[str, Any],
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    use_rope: bool = True,
    cache: Optional[Cache] = None,
    cache_index: Optional[int] = None,
    cross_source: Optional[torch.Tensor] = None,
    cross_cache: Optional[Cache] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
    """Pre-norm block: self-attention, cross-attention (given an encoder
    output or its cached K/V), then the MLP or the MoE.  Returns (x, aux
    loss, cache)."""
    h = L.norm_apply(p["attn_norm"], cfg, x)
    attn_out, cache = L.attn_apply(p["attn"], cfg, h, positions=positions, causal=causal,
                                   cache=cache, cache_index=cache_index, use_rope=use_rope)
    x = x + attn_out
    if cross_source is not None or cross_cache is not None:
        h = L.norm_apply(p["cross_norm"], cfg, x)
        if cross_cache is not None:
            cross_out = _cross_from_cache(p["cross_attn"], cfg, h, cross_cache)
        else:
            cross_out, _ = L.attn_apply(p["cross_attn"], cfg, h, positions=positions,
                                        causal=False, kv_source=cross_source, use_rope=False)
        x = x + cross_out
    h = L.norm_apply(p["mlp_norm"], cfg, x)
    if "moe" in p:
        mlp_out, aux = L.moe_apply(p["moe"], cfg, h)
    else:
        mlp_out = L.mlp_apply(p["mlp"], cfg, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + mlp_out, aux, cache


# ---------------------------------------------------------------------------
# Decoder stack
# ---------------------------------------------------------------------------


def decoder_stack_specs(cfg: ModelConfig, *, cross: bool = False) -> Dict[str, Any]:
    return stack_specs(block_specs(cfg, cross=cross), cfg.num_layers)


def decoder_stack_apply(
    layers: List[Dict[str, Any]],
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    caches: Optional[Cache] = None,  # stacked {"k","v"}
    cache_index: Optional[int] = None,
    cross_source: Optional[torch.Tensor] = None,
    cross_caches: Optional[Cache] = None,  # stacked {"k","v"} of the encoder
) -> Tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
    """Run the blocks in order.  Each layer writes its slice of the stacked
    caches in place.  Returns (hidden, total aux loss, caches or None)."""
    def body(p, x, cache, cross_cache):
        x, a, _ = block_apply(p, cfg, x, positions=positions, cache=cache,
                              cache_index=cache_index,
                              cross_source=cross_source if cross_cache is None else None,
                              cross_cache=cross_cache, use_rope=cfg.pos_emb == "rope")
        return shard_activation(x, ("batch", "seq", "act_embed")), a

    body = _maybe_remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(layers):
        cache = None if caches is None else {"k": caches["k"][i], "v": caches["v"][i]}
        cross = (None if cross_caches is None
                 else {"k": cross_caches["k"][i], "v": cross_caches["v"][i]})
        x, a = body(p, x, cache, cross)
        aux = aux + a
    return x, aux, caches


# ---------------------------------------------------------------------------
# Encoder stack (whisper): bidirectional, sinusoidal positions
# ---------------------------------------------------------------------------


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    """Fixed sinusoidal table (length, d), float32."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), 2.0 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _encoder_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    enc_cfg = cfg.replace(family="dense")  # encoder blocks are dense
    return {
        "attn_norm": L.norm_specs(enc_cfg),
        "attn": L.attn_specs(enc_cfg),
        "mlp_norm": L.norm_specs(enc_cfg),
        "mlp": L.mlp_specs(enc_cfg),
    }


def encoder_stack_specs(cfg: ModelConfig, *, stacked: bool = True) -> Dict[str, Any]:
    """The encoder's tree: ``layers`` stacked as the reference's, or with
    ``stacked=False`` as the port holds them (a list of per-layer dicts)."""
    if cfg.encoder is None:
        raise ValueError("the encoder stack needs an EncoderConfig")
    n = cfg.encoder.num_layers
    layers = (stack_specs(_encoder_layer_specs(cfg), n) if stacked
              else [_encoder_layer_specs(cfg) for _ in range(n)])
    return {"layers": layers, "final_norm": L.norm_specs(cfg)}


def encoder_stack_apply(params: Dict[str, Any], cfg: ModelConfig,
                        frames: torch.Tensor) -> torch.Tensor:
    """``frames``: (B, S, d) precomputed frame embeddings (the reference's
    stub for the conv frontend).  Bidirectional self-attention through
    `_sdpa`: the flash kernel takes only causal self-attention, as in the
    reference."""
    enc_cfg = cfg.replace(family="dense")
    cd = cfg.cdtype
    b, s, d = frames.shape
    x = frames.to(cd) + sinusoidal_positions(s, d, frames.device).to(cd)
    positions = torch.arange(s, device=frames.device)[None, :].expand(b, s)

    def body(p, h):
        h2 = L.norm_apply(p["attn_norm"], enc_cfg, h)
        attn_out, _ = L.attn_apply(p["attn"], enc_cfg, h2, positions=positions, causal=False,
                                   use_rope=False)
        h = h + attn_out
        h2 = L.norm_apply(p["mlp_norm"], enc_cfg, h)
        return shard_activation(h + L.mlp_apply(p["mlp"], enc_cfg, h2),
                                ("batch", "seq", "act_embed"))

    body = _maybe_remat(body, cfg)
    for p in params["layers"]:
        x = body(p, x)
    return L.norm_apply(params["final_norm"], cfg, x)
