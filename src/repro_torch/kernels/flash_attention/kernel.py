"""Host side of the hand-written CUDA flash-attention kernels.

Two forward kernels, built into one library: `csrc/flash_attention_wgmma.cu`
runs bf16 inputs with D a multiple of 8 on the tensor cores (`wgmma`, TMA),
and `csrc/flash_attention.cu` runs the rest (f32, and bf16 with D % 8 != 0)
on the CUDA cores.  `route` chooses between them by dtype and D alone.  The
tensor-core route also has a backward, `csrc/flash_attention_bwd_wgmma.cu`,
in the same library.

`flash_attention_cuda` checks its tensors, builds the library at first use
(`repro_torch.kernels.build`), launches the route's kernel on PyTorch's
current stream and returns the (B,T,H,D) output in q's dtype, allocated
with `torch.empty` (and, on the tensor-core route when asked, the f32
(B,H,T) row log-sum-exp the backward reads); the kernels allocate nothing.
`flash_attention_bwd_cuda` does the same for the tensor-core backward: dq,
dk and dv from q, k, v, the forward's output and log-sum-exp, and the
output's gradient.  A failed build or launch raises.

``flash_attention_cuda.launches`` counts the forward calls that launched a
kernel, and ``.tensor_core_launches`` and ``.cuda_core_launches`` those of
each route; ``flash_attention_bwd_cuda.launches`` counts the backward calls,
and never adds to the forward's counts.  So a run can show that its main
path went through them.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import load_library

__all__ = ["BLOCK_K", "BLOCK_Q", "BWD_ROW_PAD", "MAX_D", "WGMMA_BLOCK_K", "WGMMA_BLOCK_Q",
           "flash_attention_bwd_cuda", "flash_attention_cuda", "load", "route", "tiles"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = (_CSRC / "flash_attention.cu", _CSRC / "flash_attention_wgmma.cu",
            _CSRC / "flash_attention_bwd_wgmma.cu")
_NAME = "flash_attention"
BLOCK_Q = 64  # FA_BQ in flash_attention.cu (the CUDA-core kernel)
BLOCK_K = 64  # FA_BK
WGMMA_BLOCK_Q = 128  # TC_BQ in flash_attention_wgmma.cu (the tensor-core kernel)
WGMMA_BLOCK_K = 128  # TC_BK
MAX_D = 128  # FA_MAX_D, TC_MAX_D and BW_MAX_D: the zoo's largest head_dim
BWD_ROW_PAD = 128  # BW_ROW_PAD in flash_attention_bwd_wgmma.cu: its row statistics' padding
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes inputs of ``dtype`` and head dim ``d``:
    "tensor_core" for bfloat16 with d % 8 == 0 (its TMA rows are whole
    16-byte words), "cuda_core" otherwise."""
    return "tensor_core" if dtype == torch.bfloat16 and d % 8 == 0 else "cuda_core"


def tiles(dtype: torch.dtype, d: int) -> Tuple[int, int]:
    """(queries, keys) of a tile of the kernel that `route` selects."""
    if route(dtype, d) == "tensor_core":
        return WGMMA_BLOCK_Q, WGMMA_BLOCK_K
    return BLOCK_Q, BLOCK_K


def load() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources at first use."""
    lib = load_library(_NAME, _SOURCES)
    if not getattr(lib, "_repro_bound", False):
        lib.flash_attention_launch.argtypes = (
            [_P] * 4 + [_I] * 7 + [ctypes.c_float, _I, _P])
        lib.flash_attention_launch.restype = _I
        lib.flash_attention_wgmma_launch.argtypes = (
            [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _P])
        lib.flash_attention_wgmma_launch.restype = _I
        lib.flash_attention_bwd_wgmma_launch.argtypes = (
            [_P] * 11 + [_I] * 6 + [ctypes.c_float, _I, _P])
        lib.flash_attention_bwd_wgmma_launch.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        for fn in (lib.flash_attention_smem_bytes, lib.flash_attention_wgmma_smem_bytes):
            fn.argtypes = [_I]
            fn.restype = _I
        caps = (lib.flash_attention_block_q, lib.flash_attention_block_k,
                lib.flash_attention_max_d, lib.flash_attention_wgmma_block_q,
                lib.flash_attention_wgmma_block_k, lib.flash_attention_wgmma_max_d,
                lib.flash_attention_bwd_row_pad)
        for fn in caps:
            fn.argtypes = []
            fn.restype = _I
        if tuple(fn() for fn in caps) != (BLOCK_Q, BLOCK_K, MAX_D,
                                           WGMMA_BLOCK_Q, WGMMA_BLOCK_K, MAX_D, BWD_ROW_PAD):
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
    return_lse: bool = False,
):
    """Attention forward on the card: (B,T,H,D) in q's dtype; with
    ``return_lse`` (tensor-core route only), also the f32 (B,H,T) log-sum-exp
    of each row's scaled, masked scores, as ``(out, lse)``."""
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
    tensor_core = route(q.dtype, D) == "tensor_core"
    if return_lse and not tensor_core:
        raise ValueError(f"the log-sum-exp comes from the tensor-core kernel alone; "
                         f"{q.dtype} with D={D} takes the {route(q.dtype, D)} route")

    lib = load()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if tensor_core:
            q, k, v = _aligned(q, k, v)
            err = lib.flash_attention_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                B, T, S, H, KV, D, float(scale), int(bool(causal)), stream)
        else:
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, T, S, H, KV, D, float(scale), int(bool(causal)), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed ({route(q.dtype, D)} route): "
                           f"CUDA error {err} ({msg})")
    flash_attention_cuda.launches += 1
    if tensor_core:
        flash_attention_cuda.tensor_core_launches += 1
    else:
        flash_attention_cuda.cuda_core_launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.tensor_core_launches = 0
flash_attention_cuda.cuda_core_launches = 0


def _aligned(*xs: torch.Tensor):
    """TMA reads from 16-byte aligned addresses: a view at an odd offset is
    copied to a fresh (aligned) tensor."""
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in xs)


def flash_attention_bwd_cuda(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, D)
    o: torch.Tensor,  # (B, T, H, D): the forward's output
    lse: torch.Tensor,  # (B, H, T) f32: the forward's row log-sum-exp
    do: torch.Tensor,  # (B, T, H, D): the output's gradient
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward on the card, tensor-core route (bf16, D % 8 == 0):
    (dq, dk, dv), each in its input's dtype and shape.  ``do`` may be strided
    (autograd's gradients can be): it is made contiguous here."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)} and {tuple(k.shape)}")
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if route(q.dtype, D) != "tensor_core":
        raise ValueError(f"the backward kernel takes the tensor-core route (bfloat16, D % 8 == 0); "
                         f"got {q.dtype} with D={D}")
    do = do.contiguous()
    for name, x, shape, dtype in (
            ("k", k, (B, S, KV, D), q.dtype), ("v", v, (B, S, KV, D), q.dtype),
            ("o", o, (B, T, H, D), q.dtype), ("do", do, (B, T, H, D), q.dtype),
            ("lse", lse, (B, H, T), torch.float32), ("q", q, (B, T, H, D), q.dtype)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, expected {q.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (min(B, T, S, H, KV) < 1 or H % KV or D > MAX_D or B > 65535 or H > 65535):
        raise ValueError(
            f"the flash-attention backward takes D <= {MAX_D}, H a multiple of KV and "
            f"B, H <= 65535; got B={B} T={T} S={S} H={H} KV={KV} D={D}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)

    lib = load()
    q, k, v, o, do, lse = _aligned(q, k, v, o, do, lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tp = -(-T // BWD_ROW_PAD) * BWD_ROW_PAD
    di, lse2 = torch.empty((2, B, H, tp), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_wgmma_launch(
            *(x.data_ptr() for x in (q, k, v, o, lse, do, dq, dk, dv, di, lse2)),
            B, T, S, H, KV, D, float(scale), int(bool(causal)), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention backward kernel launch failed: CUDA error {err} ({msg})")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
