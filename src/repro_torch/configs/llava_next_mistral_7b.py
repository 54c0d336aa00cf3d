"""llava-next-mistral-7b: VLM on a Mistral-7B backbone
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab 32000.  The
anyres vision tower + projector are a STUB: ``input_specs`` supplies
precomputed patch embeddings (up to 2880 tokens for a 2×2 anyres grid +
base tile), which the model prepends to the text embeddings.

The same configuration as `repro/configs/llava_next_mistral_7b.py`.
"""

from repro_torch.configs.base import ArchSpec, ExecConfig
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    name="llava-next-mistral-7b",
    model=ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14_336,
        vocab_size=32_000,
        head_dim=128,
        num_patch_tokens=2880,
        param_dtype="float32",
        compute_dtype="bfloat16",
        remat_policy="full",
    ),
    exec=ExecConfig(seq_shard=True, remat="full", num_microbatches=1),
    notes="vision frontend stubbed as precomputed patch embeddings",
)
