"""Mamba-2 SSD intra-chunk term (port of `repro/kernels/ssd`).

`ref.ssd_diag_ref` is the plain oracle; `kernel.ssd_diag_cuda` is the
hand-written CUDA kernel (`csrc/ssd.cu`); `ops.ssd_diag_chunk` dispatches
between it and the plain version `ops.ssd_diag_plain` and differentiates
through the oracle.  Called from `repro_torch.models.ssm.ssd_chunked`
with ``use_kernel=True``, which the model's forward and prefill ask for.
"""
