"""whisper-tiny: encoder–decoder ASR backbone [arXiv:2212.04356].

4L encoder + 4L decoder, d_model=384, 6 heads (kv=6), d_ff=1536, vocab
51865.  LayerNorm, GELU, biased projections, learned decoder positions,
sinusoidal encoder positions.  The conv-over-mel frontend is a STUB: the
encoder consumes precomputed frame embeddings (1500 × 384) supplied by
``input_specs``.  Full attention → long_500k cell skipped (DESIGN §4.1).

The same configuration as `repro/configs/whisper_tiny.py`.
"""

from repro_torch.configs.base import ArchSpec, ExecConfig
from repro_torch.models.config import EncoderConfig, ModelConfig

SPEC = ArchSpec(
    name="whisper-tiny",
    model=ModelConfig(
        name="whisper-tiny",
        family="encdec",
        num_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        head_dim=64,
        mlp_act="gelu",
        norm="layernorm",
        use_bias=True,
        pos_emb="learned",
        max_position=32_768,  # covers the decode_32k cell
        encoder=EncoderConfig(num_layers=4, source_len=1500),
        param_dtype="float32",
        compute_dtype="bfloat16",
        remat_policy="none",  # tiny model: remat buys nothing
    ),
    exec=ExecConfig(seq_shard=True, remat="none", fsdp=False),
    notes="audio frontend stubbed; encoder fixed at 1500 frames",
)
