"""Host side of the hand-written CUDA flash-attention kernel (`csrc/flash_attention.cu`).

`flash_attention_cuda` checks its tensors, builds the library at first use
(`repro_torch.kernels.build`), launches the kernel on PyTorch's current
stream and returns the (B,T,H,D) output in q's dtype, allocated with
`torch.empty`; the kernel allocates nothing.  A failed build or launch
raises.

``flash_attention_cuda.launches`` counts the calls that launched the
kernel, so a run can show that its main path went through it.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import load_library

__all__ = ["BLOCK_K", "BLOCK_Q", "MAX_D", "flash_attention_cuda", "load"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
_NAME = "flash_attention"
BLOCK_Q = 64  # FA_BQ in the source
BLOCK_K = 64  # FA_BK in the source
MAX_D = 128  # FA_MAX_D in the source: the zoo's largest head_dim
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def load() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources at first use."""
    lib = load_library(_NAME, _SOURCES)
    if not getattr(lib, "_repro_bound", False):
        lib.flash_attention_launch.argtypes = (
            [_P] * 4 + [_I] * 7 + [ctypes.c_float, _I, _P])
        lib.flash_attention_launch.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_smem_bytes.argtypes = [_I]
        lib.flash_attention_smem_bytes.restype = _I
        for fn in (lib.flash_attention_block_q, lib.flash_attention_block_k,
                   lib.flash_attention_max_d):
            fn.argtypes = []
            fn.restype = _I
        caps = (lib.flash_attention_block_q(), lib.flash_attention_block_k(),
                lib.flash_attention_max_d())
        if caps != (BLOCK_Q, BLOCK_K, MAX_D):
            raise RuntimeError("flash_attention library caps disagree with kernel.py")
        lib._repro_bound = True
    return lib


def flash_attention_cuda(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention forward on the card: (B,T,H,D) in q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)} and {tuple(k.shape)}")
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes float32 or bfloat16")
    for name, x, shape in (("q", q, (B, T, H, D)), ("k", k, (B, S, KV, D)),
                           ("v", v, (B, S, KV, D))):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, expected {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {q.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (min(B, T, S, H, KV) < 1 or KV > H or not 4 <= D <= MAX_D or D % 4
            or B > 65535 or H > 65535):
        raise ValueError(
            f"flash_attention kernel takes 4 <= D <= {MAX_D} with D % 4 == 0, "
            f"1 <= KV <= H and B, H <= 65535; got B={B} T={T} S={S} H={H} KV={KV} D={D}"
        )
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)

    lib = load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, T, S, H, KV, D, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err} ({msg})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
