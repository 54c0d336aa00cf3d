"""Host side of the hand-written CUDA SSD intra-chunk kernel (`csrc/ssd.cu`).

`ssd_diag_cuda` checks its tensors, builds the library at first use
(`repro_torch.kernels.build`), launches the kernel on PyTorch's current
stream and returns the (BC,Q,H,P) float32 output, allocated with
`torch.empty`; the kernel allocates nothing.  B and C are read through
their strides (unit stride over N), so a head-broadcast view with head
stride 0 is read as it is, without a per-head copy.  A failed build or
launch raises.

``ssd_diag_cuda.launches`` counts the calls that launched the kernel, so a
run can show that its main path went through it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

__all__ = ["BLOCK", "MAX_N", "MAX_P", "MAX_Q", "load", "ssd_diag_cuda"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "ssd.cu",)
_NAME = "ssd"
BLOCK = 64  # SSD_BQ in the source: query rows of a block, key rows of a tile
MAX_Q = 256  # SSD_MAX_Q: the zoo's chunk size
MAX_N = 128  # SSD_MAX_N: the zoo's largest state
MAX_P = 64  # SSD_MAX_P: the zoo's largest SSD head dim

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def load() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources at first use."""
    lib = load_library(_NAME, _SOURCES)
    if not getattr(lib, "_repro_bound", False):
        lib.ssd_diag_launch.argtypes = [_P] * 6 + [_I] * 5 + [_L] * 6 + [_P]
        lib.ssd_diag_launch.restype = _I
        lib.ssd_diag_error_string.argtypes = [_I]
        lib.ssd_diag_error_string.restype = ctypes.c_char_p
        lib.ssd_diag_smem_bytes.argtypes = [_I]
        lib.ssd_diag_smem_bytes.restype = _I
        for fn in (lib.ssd_diag_block, lib.ssd_diag_max_q, lib.ssd_diag_max_n,
                   lib.ssd_diag_max_p):
            fn.argtypes = []
            fn.restype = _I
        caps = (lib.ssd_diag_block(), lib.ssd_diag_max_q(), lib.ssd_diag_max_n(),
                lib.ssd_diag_max_p())
        if caps != (BLOCK, MAX_Q, MAX_N, MAX_P):
            raise RuntimeError("ssd library caps disagree with kernel.py")
        lib._repro_bound = True
    return lib


def ssd_diag_cuda(
    x: torch.Tensor,  # (BC, Q, H, P)
    dt: torch.Tensor,  # (BC, Q, H)
    lA: torch.Tensor,  # (BC, Q, H)
    B_: torch.Tensor,  # (BC, Q, H, N), any strides but unit stride over N
    C_: torch.Tensor,  # (BC, Q, H, N)
) -> torch.Tensor:
    """The intra-chunk term on the card: (BC,Q,H,P) float32."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_diag_cuda needs CUDA tensors, got {x.device}")
    if x.dim() != 4 or B_.dim() != 4:
        raise ValueError(f"x and B must be 4-D, got {tuple(x.shape)} and {tuple(B_.shape)}")
    BC, Q, H, P = x.shape
    N = B_.shape[-1]
    for name, a, shape, strided in (
            ("x", x, (BC, Q, H, P), False), ("dt", dt, (BC, Q, H), False),
            ("lA", lA, (BC, Q, H), False), ("B", B_, (BC, Q, H, N), True),
            ("C", C_, (BC, Q, H, N), True)):
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
    if min(BC, Q, H, P, N) < 1 or Q > MAX_Q or P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd kernel takes Q <= {MAX_Q}, P <= {MAX_P}, N <= {MAX_N}; "
                         f"got BC={BC} Q={Q} H={H} P={P} N={N}")

    lib = load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.ssd_diag_launch(
            x.data_ptr(), dt.data_ptr(), lA.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            y.data_ptr(), BC, Q, H, P, N, *B_.stride()[:3], *C_.stride()[:3],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        msg = lib.ssd_diag_error_string(err).decode()
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err} ({msg})")
    ssd_diag_cuda.launches += 1
    return y


ssd_diag_cuda.launches = 0
