"""Fused RMSNorm (port of `repro/kernels/rmsnorm`).

`ref.rmsnorm_ref` is the plain oracle; `kernel.rmsnorm_cuda` is the
hand-written CUDA kernel (`csrc/rmsnorm.cu`); `ops.rmsnorm` dispatches
between it and the plain version `ops.rmsnorm_plain` and differentiates
through the oracle.  As in the reference, no model calls it (the models'
`norm_apply` is plain): its path is the op itself.
"""
