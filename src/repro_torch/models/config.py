"""Model configuration (port of `repro/models/config.py`).

The same frozen dataclasses as the reference, field for field, so a
configuration reads the same in both packages; ``pdtype`` and ``cdtype``
are torch dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["EncoderConfig", "ModelConfig", "MoEConfig", "SSMConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual: bool = False  # Arctic: dense MLP residual alongside MoE
    shared_experts: int = 0  # Kimi-style always-on shared expert(s)
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder side of an encoder-decoder model (whisper): the encoder
    consumes precomputed frame embeddings."""

    num_layers: int
    source_len: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- attention/MLP flavor ------------------------------------------------
    qk_norm: bool = False  # qwen3
    qkv_bias: bool = False  # qwen1.5
    mlp_act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"  # rope | learned | none
    max_position: int = 0  # learned pos-emb table size (0 = seq-dependent)
    tie_embeddings: bool = False
    use_bias: bool = False  # biases on projections (whisper)
    # --- family extensions ---------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0
    encoder: Optional[EncoderConfig] = None
    num_patch_tokens: int = 0
    # --- numerics ------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # --- execution -----------------------------------------------------------
    attention_impl: str = "auto"  # auto | dense | chunked | pallas
    attention_chunk: int = 1024
    remat_policy: str = "none"  # none | dots | full
    sub_quadratic: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.num_heads and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.family in ("ssm",) and self.ssm is None:
            raise ValueError("ssm family requires SSMConfig")
        if self.family == "hybrid" and (self.ssm is None or not self.hybrid_attn_every):
            raise ValueError("hybrid family requires SSMConfig and attn period")
        if self.family == "encdec" and self.encoder is None:
            raise ValueError("encdec family requires EncoderConfig")
        if self.family == "moe" and self.moe is None:
            raise ValueError("moe family requires MoEConfig")
