"""Causal GQA flash attention (port of `repro/kernels/flash_attention`).

`ref.attention_ref` is the plain oracle; `kernel.flash_attention_cuda` is
the hand-written CUDA kernel (`csrc/flash_attention.cu`); `ops.flash_attention`
dispatches between it and the plain version `ops.flash_attention_plain`
and differentiates through the oracle.  Called from
`repro_torch.models.layers.attn_apply` where the reference calls its
Pallas kernel.
"""
