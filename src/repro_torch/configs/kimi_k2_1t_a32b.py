"""kimi-k2-1t-a32b: trillion-parameter MoE (paper-table config).

61L, d_model=7168, 64 heads (GQA kv=8, head_dim 112), vocab 163840,
MoE: 384 experts, top-8, d_ff_expert=2048, one always-on shared expert
(Kimi/DeepSeek-V3 style).  ~1.04 T total / ~32 B active parameters.

Execution: at 1e12 parameters, AdamW's f32 master+moments (16 B/param)
cannot fit a 4 TB single pod — the config selects bf16 params + Adafactor
(factored second moment, no momentum) + full remat + bf16 gradient
accumulation, which is how trillion-parameter MoEs are actually trained.

The same configuration as `repro/configs/kimi_k2_1t_a32b.py`.
"""

from repro_torch.configs.base import ArchSpec, ExecConfig
from repro_torch.models.config import ModelConfig, MoEConfig

SPEC = ArchSpec(
    name="kimi-k2-1t-a32b",
    model=ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,  # shared-expert width
        vocab_size=163_840,
        head_dim=112,
        moe=MoEConfig(
            num_experts=384,
            top_k=8,
            d_ff_expert=2048,
            capacity_factor=1.25,
            shared_experts=1,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat_policy="full",
    ),
    exec=ExecConfig(
        seq_shard=True,
        optimizer="adafactor",
        num_microbatches=4,
        accum_dtype="bfloat16",
        fsdp=True,
        remat="full",
    ),
    notes="1T-param MoE; Adafactor+bf16 params to fit pod HBM",
)
