"""Config plumbing shared by the per-architecture config modules (port of
`repro/configs/base.py`).

`ExecConfig` carries the execution knobs that are not part of the
architecture (optimizer, microbatching, remat, FSDP); `ArchSpec` bundles a
`ModelConfig` with its default `ExecConfig`; `smoke_variant` shrinks any
architecture to a CPU-runnable size, exactly as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.config import EncoderConfig, ModelConfig, MoEConfig, SSMConfig

__all__ = ["ArchSpec", "ExecConfig", "smoke_variant"]


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution configuration for a training/serving job."""

    optimizer: str = "adamw"  # adamw | adafactor
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0
    num_microbatches: int = 1
    accum_dtype: Optional[str] = None
    fsdp: bool = True
    remat: str = "dots"
    bf16_grad_reduce: bool = True
    seq_shard: bool = False

    def replace(self, **kw) -> "ExecConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    model: ModelConfig
    exec: ExecConfig = ExecConfig()
    notes: str = ""

    def replace_model(self, **kw) -> "ArchSpec":
        return dataclasses.replace(self, model=self.model.replace(**kw))


def smoke_variant(spec: ArchSpec) -> ArchSpec:
    """Reduced same-family config: tiny widths, few layers, small tables."""
    m = spec.model
    kw = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(m.num_kv_heads, 4) if m.num_kv_heads > 1 else 1,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        max_position=256 if m.pos_emb == "learned" else 0,
        num_patch_tokens=8 if m.family == "vlm" else 0,
        remat_policy="none",
    )
    if m.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=8,
            top_k=min(m.moe.top_k, 2),
            d_ff_expert=32,
            capacity_factor=m.moe.capacity_factor,
            dense_residual=m.moe.dense_residual,
            shared_experts=m.moe.shared_experts,
        )
    if m.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                              n_groups=1, chunk_size=8)
    if m.hybrid_attn_every:
        kw["hybrid_attn_every"] = 2
    if m.encoder is not None:
        kw["encoder"] = EncoderConfig(num_layers=2, source_len=16)
    return dataclasses.replace(
        spec,
        name=spec.name + "-smoke",
        model=m.replace(**kw),
        exec=spec.exec.replace(num_microbatches=1, fsdp=False, remat="none"),
    )
