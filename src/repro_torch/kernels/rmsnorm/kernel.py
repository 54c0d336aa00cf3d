"""Host side of the hand-written CUDA RMSNorm kernel (`csrc/rmsnorm.cu`).

`rmsnorm_cuda` checks its tensors, builds the library at first use
(`repro_torch.kernels.build`), launches the kernel on PyTorch's current
stream and returns the (rows, D) output in x's dtype, allocated with
`torch.empty_like`; the kernel allocates nothing.  A failed build or launch
raises.

``rmsnorm_cuda.launches`` counts the calls that launched the kernel, so a
run can show that its main path went through it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

__all__ = ["MAX_D", "WARP_MAX_D", "load", "rmsnorm_cuda"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu",)
_NAME = "rmsnorm"
MAX_D = 32768  # RN_MAX_D in the source: 32 values a thread, 1024 threads a row
WARP_MAX_D = 1024  # RN_WARP_MAX_D: a warp owns a row up to here, a block above
# (bf16 rows in 16-byte words: a warp's up to D = 8192, RN_WARP_BF16_MAX_D)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p


def load() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources at first use."""
    lib = load_library(_NAME, _SOURCES)
    if not getattr(lib, "_repro_bound", False):
        lib.rmsnorm_launch.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_float, _P]
        lib.rmsnorm_launch.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        for fn in (lib.rmsnorm_max_d, lib.rmsnorm_warp_max_d):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        if (lib.rmsnorm_max_d(), lib.rmsnorm_warp_max_d()) != (MAX_D, WARP_MAX_D):
            raise RuntimeError("rmsnorm library caps disagree with kernel.py")
        lib._repro_bound = True
    return lib


def rmsnorm_cuda(
    x: torch.Tensor,  # (rows, D), float32 or bfloat16, contiguous
    scale: torch.Tensor,  # (D,) float32, contiguous
    eps: float = 1e-6,
) -> torch.Tensor:
    """Row-wise ``x * rsqrt(mean(x²) + eps) * scale`` on the card: (rows, D) in x's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_cuda needs CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (rows, D), got {tuple(x.shape)}")
    rows, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes float32 or bfloat16")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale has dtype {scale.dtype}; the kernel takes float32")
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, expected {x.device}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale has shape {tuple(scale.shape)}, expected {(d,)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"rmsnorm kernel takes 1 <= D <= {MAX_D}, got D={d}")
    out = torch.empty_like(x)
    if rows == 0:
        return out

    lib = load()
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_launch(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], rows, d,
            float(eps), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        msg = lib.rmsnorm_error_string(err).decode()
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err} ({msg})")
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0
