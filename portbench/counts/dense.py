"""Operations of a dense decoder's forward (pre-norm blocks of grouped-query
attention and an MLP), from the configuration file's sizes: matrix products
at 2·M·N·K, attention as its causal pairs."""

from __future__ import annotations

from typing import Dict

__all__ = ["attention_layers", "forward_flops"]


def _attn_proj(c: dict, tokens: int) -> float:
    d, h, kv, hd = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"]
    return 2.0 * tokens * d * hd * (2 * h + 2 * kv)  # q, k, v in; o out


def _mlp(c: dict, tokens: int) -> float:
    mats = 3 if c["mlp_act"] == "swiglu" else 2
    return 2.0 * tokens * c["d_model"] * c["d_ff"] * mats


def _attn_pairs(c: dict, b: int, t: int) -> float:
    """q.k and p.v over the causal pairs of ``b`` sequences of ``t``."""
    return 4.0 * c["head_dim"] * c["num_heads"] * b * (t * (t + 1) // 2)


def attention_layers(c: dict) -> int:
    """Attention calls of one forward."""
    return c["num_layers"]


def forward_flops(c: dict, b: int, t: int) -> Dict[str, float]:
    """The layers' operations over ``b`` sequences of ``t`` tokens, without
    the unembedding (`counts.forward_flops` adds it): ``matmul`` (the
    projections and the MLP) and ``attention``."""
    layers = c["num_layers"]
    return {"matmul": layers * (_attn_proj(c, b * t) + _mlp(c, b * t)),
            "attention": layers * _attn_pairs(c, b, t)}
