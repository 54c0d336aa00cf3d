"""Causal GQA flash attention (port of `repro/kernels/flash_attention`).

`ref.attention_ref` is the plain oracle; `kernel.flash_attention_cuda` runs
the hand-written CUDA kernels (`csrc/flash_attention.cu`,
`csrc/flash_attention_wgmma.cu`) and `kernel.flash_attention_bwd_cuda` the
tensor-core route's backward (`csrc/flash_attention_bwd_wgmma.cu`);
`ops.flash_attention` dispatches between them and the plain versions
(`ops.flash_attention_plain`, `ops.flash_attention_backward_plain`), and
differentiates through the backward kernel on the tensor-core route and
through the oracle elsewhere.  Called from
`repro_torch.models.layers.attn_apply` where the reference calls its
Pallas kernel.
"""
