"""granite-8b: IBM Granite code model, llama architecture [arXiv:2405.04324].

36L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab 49152.

The same configuration as `repro/configs/granite_8b.py`.
"""

from repro_torch.configs.base import ArchSpec, ExecConfig
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    name="granite-8b",
    model=ModelConfig(
        name="granite-8b",
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14_336,
        vocab_size=49_152,
        head_dim=128,
        param_dtype="float32",
        compute_dtype="bfloat16",
        remat_policy="full",
    ),
    exec=ExecConfig(seq_shard=True, remat="full", num_microbatches=1),
)
