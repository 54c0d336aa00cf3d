"""Host side of the hand-written CUDA EI/argmax kernel (`csrc/ei_argmax.cu`).

`ei_argmax_cuda` checks its tensors, builds the library at first use
(`repro_torch.kernels.build`), launches the kernel on PyTorch's current
stream and returns ((J,) int32 argmax, (J,) float32 max EI).  It allocates
the outputs and the per-block partials with `torch.empty`; the kernel
allocates nothing.  The kernel folds the partials itself (the last block of
a job to finish), counting finished blocks in a per-device int32 buffer
that each call leaves at 0 for the next.  Calls on a device share that
buffer, which is safe because they share one stream, so the device runs
them one after another: every host thread's current stream is the device's
default stream, and the port creates no streams on the paths that call the
kernel (the fleet's service calls it from several threads).  A failed
build or launch raises.

The library picks the route by (B, d): B <= 64 and d <= 8 take the
register route (a candidate's features and its triangular solve in
registers, in buckets of B), every other shape the blocked route (a block's
right-hand sides in shared memory, a blocked forward substitution over L);
the register route took 0.42-0.81x the blocked route's device time at
the catalog's and the n512 fixture's shapes on an H100 (`PERF.md`).  Neither
caps n, B or d beyond the grid (J <= 65535) and, on the blocked route, one
candidate's right-hand side beside the staged training rows in a block's
shared memory: B + d + 1 <= 55296 - r(d + 3) with r = min(64, 4096 // d),
so B <= 54713 at d = 6 (`blocked_tile` in the source).  `_launch` forces
one route, for the tests that hold each against the plain version.

``ei_argmax_cuda.launches`` counts the calls that launched the kernel (one
launch a call), so a run can show that its main path went through it.  The
count and the creation of a device's buffer happen under one lock, so
threads that launch at once neither lose a count nor make two buffers.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels.build import load_library

__all__ = ["ei_argmax_cuda", "load"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "ei_argmax.cu",)
_NAME = "ei_argmax"
_AUTO, _REGISTERS, _BLOCKED = 0, 1, 2  # the library's route codes (`ei_argmax_tile`)

_P = ctypes.c_void_p
_I = ctypes.c_int
_DONE: Dict[torch.device, torch.Tensor] = {}  # finished-block counts, per device
_LOCK = threading.Lock()  # guards _DONE and the launch count


def load() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources at first use."""
    lib = load_library(_NAME, _SOURCES)
    if not getattr(lib, "_repro_bound", False):
        lib.ei_argmax_launch.argtypes = [_P] * 12 + [_I] * 4 + [ctypes.c_float, _I, _P]
        lib.ei_argmax_launch.restype = _I
        lib.ei_argmax_error_string.argtypes = [_I]
        lib.ei_argmax_error_string.restype = ctypes.c_char_p
        lib.ei_argmax_tile.argtypes = [_I] * 4
        lib.ei_argmax_tile.restype = _I
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


def _done(dev: torch.device, J: int) -> torch.Tensor:
    """At least J zeroed counts on ``dev``, kept between calls (each call
    leaves them at 0)."""
    with _LOCK:
        buf = _DONE.get(dev)
        if buf is None or buf.numel() < J:
            buf = _DONE[dev] = torch.zeros(max(J, 64), dtype=torch.int32, device=dev)
        return buf


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
    return _launch(enc, mask, feats, pm, alpha, chol, scal, xi, _AUTO)


def _launch(enc, mask, feats, pm, alpha, chol, scal, xi: float, route: int):
    """`ei_argmax_cuda` on ``route``: `_AUTO`, or `_REGISTERS` / `_BLOCKED`
    forced (raising where that route cannot take the shape)."""
    if enc.device.type != "cuda":
        raise ValueError(f"ei_argmax_cuda needs CUDA tensors, got {enc.device}")
    if enc.dim() != 3 or feats.dim() != 3:
        raise ValueError(f"enc and feats must be 3-D, got {tuple(enc.shape)} and "
                         f"{tuple(feats.shape)}")
    J, n, d = enc.shape
    B = feats.shape[1]
    if min(n, d, B) < 1 or not 1 <= J <= 65535:
        raise ValueError(f"ei_argmax kernel takes n, d, B >= 1 and 1 <= J <= 65535; "
                         f"got n={n} d={d} B={B} J={J}")
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
    tile = lib.ei_argmax_tile(n, d, B, route)
    if tile < 1:
        what = {_AUTO: "", _REGISTERS: "register route of the ", _BLOCKED: "blocked route of the "}
        raise ValueError(f"the {what[route]}ei_argmax kernel cannot take d={d} B={B}")
    nb = -(-n // tile)
    part_val = torch.empty((J, nb), dtype=f32, device=dev)
    part_idx = torch.empty((J, nb), dtype=torch.int32, device=dev)
    out_val = torch.empty(J, dtype=f32, device=dev)
    out_idx = torch.empty(J, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        done = _done(dev, J)
        err = lib.ei_argmax_launch(
            enc.data_ptr(), mask.data_ptr(), feats.data_ptr(), pm.data_ptr(),
            alpha.data_ptr(), chol.data_ptr(), scal.data_ptr(),
            part_val.data_ptr(), part_idx.data_ptr(), done.data_ptr(),
            out_val.data_ptr(), out_idx.data_ptr(),
            J, n, d, B, float(xi), route, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.ei_argmax_error_string(err).decode()
        raise RuntimeError(f"ei_argmax kernel launch failed: CUDA error {err} ({msg})")
    with _LOCK:
        ei_argmax_cuda.launches += 1
    return out_idx, out_val


ei_argmax_cuda.launches = 0
