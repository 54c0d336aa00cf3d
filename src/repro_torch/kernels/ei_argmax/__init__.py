"""Fused posterior+EI+argmax over the candidate axis (port of `repro/kernels/ei_argmax`).

`tile.ei_from_sqdist` is the shared EI tail; `kernel.ei_argmax_cuda` is the
hand-written CUDA kernel (`csrc/ei_argmax.cu`); `ops.ei_argmax` dispatches
between it and the plain version `ops.ei_argmax_plain`.  Wired into the
search as ``layout="fused"`` (`repro_torch.core.fast_bo.bo_step_core_fused`).
"""
