"""Host side of the hand-written CUDA SSD intra-chunk kernel (`csrc/ssd_wgmma.cu`).

`ssd_diag_cuda` checks its tensors, builds the library at first use
(`repro_torch.kernels.build`), launches the prefix-sum pass and the
tensor-core kernel on PyTorch's current stream and returns the (BC,Q,H,P)
float32 output.  It allocates the output and the (BC,Q,H) prefix-sum
scratch with `torch.empty`; the kernel allocates nothing.  B and C are
(BC,Q,G,N) with G dividing H (head h reads group h // (H // G)), read
through their strides (unit stride over N): the grouped tensor, or a
head-broadcast view with head stride 0, reaches the kernel uncopied.  No
shape is capped beyond the grid's 2^31 - 1 blocks.  A failed build or
launch raises.

``ssd_diag_cuda.launches`` counts the calls that launched the kernel, so a
run can show that its main path went through it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

__all__ = ["BLOCK", "load", "ssd_diag_cuda"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "ssd_wgmma.cu",)
_NAME = "ssd"
BLOCK = 64  # SW_BQ and SW_BK in the source: query rows of a block, key rows of a tile

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def load() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources at first use."""
    lib = load_library(_NAME, _SOURCES)
    if not getattr(lib, "_repro_bound", False):
        lib.ssd_diag_launch.argtypes = [_P] * 7 + [_I] * 6 + [_L] * 6 + [_P]
        lib.ssd_diag_launch.restype = _I
        lib.ssd_diag_error_string.argtypes = [_I]
        lib.ssd_diag_error_string.restype = ctypes.c_char_p
        for fn in (lib.ssd_diag_block, lib.ssd_diag_smem_bytes):
            fn.argtypes = []
            fn.restype = _I
        if lib.ssd_diag_block() != BLOCK:
            raise RuntimeError("ssd library tile disagrees with kernel.py")
        lib._repro_bound = True
    return lib


def ssd_diag_cuda(
    x: torch.Tensor,  # (BC, Q, H, P)
    dt: torch.Tensor,  # (BC, Q, H)
    lA: torch.Tensor,  # (BC, Q, H)
    B_: torch.Tensor,  # (BC, Q, G, N), G | H, any strides but unit stride over N
    C_: torch.Tensor,  # (BC, Q, G, N)
) -> torch.Tensor:
    """The intra-chunk term on the card: (BC,Q,H,P) float32."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_diag_cuda needs CUDA tensors, got {x.device}")
    if x.dim() != 4 or B_.dim() != 4:
        raise ValueError(f"x and B must be 4-D, got {tuple(x.shape)} and {tuple(B_.shape)}")
    BC, Q, H, P = x.shape
    G, N = B_.shape[2:]
    if min(BC, Q, H, P, G, N) < 1 or H % G:
        raise ValueError(f"ssd kernel takes nonempty tensors with G dividing H; got BC={BC} "
                         f"Q={Q} H={H} P={P} G={G} N={N}")
    for name, a, shape, strided in (
            ("x", x, (BC, Q, H, P), False), ("dt", dt, (BC, Q, H), False),
            ("lA", lA, (BC, Q, H), False), ("B", B_, (BC, Q, G, N), True),
            ("C", C_, (BC, Q, G, N), True)):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, expected {x.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {a.dtype}; the kernel takes float32")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {shape}")
        if strided and N > 1 and a.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride over N, got {a.stride()}")
        if not strided and not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    lib = load()
    y = torch.empty_like(x)
    cs = torch.empty_like(dt)
    with torch.cuda.device(x.device):
        err = lib.ssd_diag_launch(
            x.data_ptr(), dt.data_ptr(), lA.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            y.data_ptr(), cs.data_ptr(), BC, Q, H, G, P, N, *B_.stride()[:3],
            *C_.stride()[:3], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        msg = lib.ssd_diag_error_string(err).decode()
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err} ({msg})")
    ssd_diag_cuda.launches += 1
    return y


ssd_diag_cuda.launches = 0
