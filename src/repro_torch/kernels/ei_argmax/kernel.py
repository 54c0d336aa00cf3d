"""Host side of the hand-written CUDA EI/argmax kernel (`csrc/ei_argmax.cu`).

`ei_argmax_cuda` checks its tensors, builds the library at first use
(`repro_torch.kernels.build`), launches the kernel on PyTorch's current
stream and returns ((J,) int32 argmax, (J,) float32 max EI).  It allocates
the outputs and the per-block partials with `torch.empty`; the kernel
allocates nothing.  A failed build or launch raises.

``ei_argmax_cuda.launches`` counts the calls that launched the kernel
(one call is one tile pass and one reduce pass), so a run can show that
its main path went through it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

__all__ = ["MAX_B", "MAX_D", "ei_argmax_cuda", "load"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "ei_argmax.cu",)
_NAME = "ei_argmax"
MAX_B = 128  # EI_MAX_B in the source: L takes 64 KB of shared memory
MAX_D = 32  # EI_MAX_D in the source

_P = ctypes.c_void_p
_I = ctypes.c_int


def load() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources at first use."""
    lib = load_library(_NAME, _SOURCES)
    if not getattr(lib, "_repro_bound", False):
        lib.ei_argmax_launch.argtypes = [_P] * 11 + [_I] * 4 + [ctypes.c_float, _P]
        lib.ei_argmax_launch.restype = _I
        lib.ei_argmax_error_string.argtypes = [_I]
        lib.ei_argmax_error_string.restype = ctypes.c_char_p
        for fn in (lib.ei_argmax_block, lib.ei_argmax_max_b, lib.ei_argmax_max_d):
            fn.argtypes = []
            fn.restype = _I
        if (lib.ei_argmax_max_b(), lib.ei_argmax_max_d()) != (MAX_B, MAX_D):
            raise RuntimeError("ei_argmax library caps disagree with kernel.py")
        lib._repro_bound = True
    return lib


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ei_argmax_cuda(
    enc: torch.Tensor,  # (J, n, d) f32
    mask: torch.Tensor,  # (J, n) bool
    feats: torch.Tensor,  # (J, B, d) f32
    pm: torch.Tensor,  # (J, B) f32
    alpha: torch.Tensor,  # (J, B) f32
    chol: torch.Tensor,  # (J, B, B) f32
    scal: torch.Tensor,  # (J, 4) f32: lengthscale, y_mean, y_std, best
    xi: float = 0.0,
):
    """((J,) int32 argmax, (J,) f32 max EI) of the masked EI, on the card."""
    if enc.device.type != "cuda":
        raise ValueError(f"ei_argmax_cuda needs CUDA tensors, got {enc.device}")
    J, n, d = enc.shape
    B = feats.shape[1]
    if n < 1 or not 1 <= d <= MAX_D or not 1 <= B <= MAX_B or not 1 <= J <= 65535:
        raise ValueError(
            f"ei_argmax kernel takes n >= 1, d <= {MAX_D}, B <= {MAX_B}, "
            f"J <= 65535; got n={n} d={d} B={B} J={J}"
        )
    dev = enc.device
    f32 = torch.float32
    _check("enc", enc, f32, (J, n, d), dev)
    _check("mask", mask, torch.bool, (J, n), dev)
    _check("feats", feats, f32, (J, B, d), dev)
    _check("pm", pm, f32, (J, B), dev)
    _check("alpha", alpha, f32, (J, B), dev)
    _check("chol", chol, f32, (J, B, B), dev)
    _check("scal", scal, f32, (J, 4), dev)

    lib = load()
    nb = -(-n // lib.ei_argmax_block())
    part_val = torch.empty((J, nb), dtype=f32, device=dev)
    part_idx = torch.empty((J, nb), dtype=torch.int32, device=dev)
    out_val = torch.empty(J, dtype=f32, device=dev)
    out_idx = torch.empty(J, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ei_argmax_launch(
            enc.data_ptr(), mask.data_ptr(), feats.data_ptr(), pm.data_ptr(),
            alpha.data_ptr(), chol.data_ptr(), scal.data_ptr(),
            part_val.data_ptr(), part_idx.data_ptr(),
            out_val.data_ptr(), out_idx.data_ptr(),
            J, n, d, B, float(xi), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.ei_argmax_error_string(err).decode()
        raise RuntimeError(f"ei_argmax kernel launch failed: CUDA error {err} ({msg})")
    ei_argmax_cuda.launches += 1
    return out_idx, out_val


ei_argmax_cuda.launches = 0
