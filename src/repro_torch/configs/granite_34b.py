"""granite-34b: IBM Granite 34B code model, MQA [arXiv:2405.04324].

88L, d_model=6144, 48 heads with a SINGLE kv head (MQA), d_ff=24576,
vocab 49152.  The kv=1 head cannot shard over the 16-way model axis — the
divisibility-aware sharding rules keep K/V replicated while Q/O stay
tensor-parallel (see parallel/sharding.py).

The same configuration as `repro/configs/granite_34b.py`.
"""

from repro_torch.configs.base import ArchSpec, ExecConfig
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    name="granite-34b",
    model=ModelConfig(
        name="granite-34b",
        family="dense",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        d_ff=24_576,
        vocab_size=49_152,
        head_dim=128,
        param_dtype="float32",
        compute_dtype="bfloat16",
        remat_policy="full",
    ),
    exec=ExecConfig(seq_shard=True, remat="full", num_microbatches=1),
    notes="MQA: kv stays replicated on the model axis",
)
