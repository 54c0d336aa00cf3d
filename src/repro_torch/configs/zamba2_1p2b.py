"""zamba2-1.2b: Mamba2 backbone + shared attention [arXiv:2411.15242].

38 Mamba-2 layers (d_model=2048, d_inner=4096, ssm_state=64, head_dim 64)
with ONE weight-shared attention+MLP block (32 heads, kv=32, d_ff=8192)
applied every 6 layers.  Sub-quadratic backbone → runs the long_500k cell
(the shared block's KV cache is the only attention state).

The same configuration as `repro/configs/zamba2_1p2b.py`.
"""

from repro_torch.configs.base import ArchSpec, ExecConfig
from repro_torch.models.config import ModelConfig, SSMConfig

SPEC = ArchSpec(
    name="zamba2-1.2b",
    model=ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32_000,
        head_dim=64,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=256),
        hybrid_attn_every=6,
        sub_quadratic=True,
        param_dtype="float32",
        compute_dtype="bfloat16",
        remat_policy="full",
    ),
    exec=ExecConfig(seq_shard=True, remat="full", num_microbatches=2),
    notes="shared attn block every 6 mamba layers; LoRA adapters omitted",
)
