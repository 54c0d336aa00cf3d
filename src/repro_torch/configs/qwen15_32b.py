"""qwen1.5-32b: Qwen1.5 with QKV bias, full MHA [hf:Qwen/Qwen1.5 family].

64L, d_model=5120, 40 heads (kv=40 — no grouping), d_ff=27392,
vocab 152064, biases on the QKV projections.

The same configuration as `repro/configs/qwen15_32b.py`.
"""

from repro_torch.configs.base import ArchSpec, ExecConfig
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    name="qwen1.5-32b",
    model=ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27_392,
        vocab_size=152_064,
        head_dim=128,
        qkv_bias=True,
        param_dtype="float32",
        compute_dtype="bfloat16",
        remat_policy="full",
    ),
    exec=ExecConfig(seq_shard=True, remat="full", num_microbatches=1),
)
