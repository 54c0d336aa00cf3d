"""mamba2-370m — pure SSD state-space model [arXiv:2405.21060].

48L, d_model=1024 (d_inner=2048, 32 SSD heads of dim 64, state=128),
attention-free, vocab 50280, tied embeddings.  The same configuration as
`repro/configs/mamba2_370m.py`.
"""

from repro_torch.configs.base import ArchSpec, ExecConfig
from repro_torch.models.config import ModelConfig, SSMConfig

SPEC = ArchSpec(
    name="mamba2-370m",
    model=ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50_280,
        head_dim=64,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=256),
        sub_quadratic=True,
        param_dtype="float32",
        compute_dtype="bfloat16",
        remat_policy="full",
    ),
    exec=ExecConfig(seq_shard=True, remat="full"),
    notes="attention-free; decode state is O(1) in sequence length",
)
