"""qwen3-8b: Qwen3 with per-head qk-norm [hf:Qwen/Qwen3-8B].

36L, d_model=4096, 32 heads (GQA kv=8), d_ff=12288, vocab 151936, RMSNorm
applied to q and k per head before RoPE.  The same configuration as
`repro/configs/qwen3_8b.py`.
"""

from repro_torch.configs.base import ArchSpec, ExecConfig
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    name="qwen3-8b",
    model=ModelConfig(
        name="qwen3-8b",
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12_288,
        vocab_size=151_936,
        head_dim=128,
        qk_norm=True,
        param_dtype="float32",
        compute_dtype="bfloat16",
        remat_policy="full",
    ),
    exec=ExecConfig(seq_shard=True, remat="full", num_microbatches=1),
)
