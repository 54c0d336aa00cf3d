"""Helpers of the per-layer readers (this file is no metric)."""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from portbench import counts  # noqa: E402

FLASH_KERNELS = ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")  # K2's device names


def note(msg: str) -> None:
    print(f"portbench metric: {msg}", file=sys.stderr)


def roofline(run, calls, bound_fn, kernels, counter: str):
    """100 x the least time of ``calls`` over the device time of ``kernels``
    in the traced window, or None where nothing ran or the launch counter
    disagrees with the calls reckoned from the shapes."""
    if run.trace is None:
        return None
    want = sum(n for _, n in calls)
    got = run.traced["launches"][counter]
    if got != want:
        note(f"{counter}: {got} launches in the traced window, {want} reckoned from the shapes")
        return None
    spent = run.trace.kernel_s(kernels)
    if not want or spent <= 0:
        return None
    return 100.0 * counts.bound_ms(calls, bound_fn) / 1e3 / spent


def idle(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
