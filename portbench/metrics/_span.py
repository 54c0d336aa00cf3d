"""Helpers of the readers of the program's profiler ranges (this file is no
metric): the device time under a range in the traced window, per traced
training step or per traced batch, in milliseconds.  None where the run was
not traced or its trace holds no such range (a program without it)."""

from __future__ import annotations


def _range_ms(run, name: str):
    if run.trace is None or name not in run.trace.ranges_s:
        return None
    return 1e3 * run.trace.ranges_s[name]


def per_step_ms(run, name: str):
    ms, steps = _range_ms(run, name), run.traced.get("steps")
    return ms / steps if ms is not None and steps else None


def per_batch_ms(run, name: str):
    ms, batches = _range_ms(run, name), len(run.traced.get("batches", ()))
    return ms / batches if ms is not None and batches else None
