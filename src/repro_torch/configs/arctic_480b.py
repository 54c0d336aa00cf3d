"""arctic-480b: Snowflake Arctic: dense-MoE hybrid
[hf:Snowflake/snowflake-arctic-base].

35L, d_model=7168, 56 heads (GQA kv=8), vocab 32000.  Every layer combines
a *dense residual* MLP (d_ff=4864) with a 128-expert top-2 MoE
(d_ff_expert=4864) — Arctic's signature architecture.  ~480 B total
parameters, ~17 B active.

The same configuration as `repro/configs/arctic_480b.py`.
"""

from repro_torch.configs.base import ArchSpec, ExecConfig
from repro_torch.models.config import ModelConfig, MoEConfig

SPEC = ArchSpec(
    name="arctic-480b",
    model=ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,  # dense-residual width
        vocab_size=32_000,
        head_dim=128,
        moe=MoEConfig(
            num_experts=128,
            top_k=2,
            d_ff_expert=4864,
            capacity_factor=1.25,
            dense_residual=True,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat_policy="full",
        attention_impl="chunked",
        attention_chunk=2048,
    ),
    exec=ExecConfig(
        seq_shard=True,
        optimizer="adafactor",
        num_microbatches=4,
        accum_dtype="bfloat16",
        fsdp=True,
        remat="full",
    ),
    notes="dense residual MLP + 128e top-2 MoE per layer",
)
