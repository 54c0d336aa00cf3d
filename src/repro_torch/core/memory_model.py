"""Memory-usage modeling and categorization (paper §III-C).

Given profiling readings ``(input_size_i, peak_memory_i)`` from small sample
runs, fit ordinary least squares ``mem = slope * size + intercept`` and
categorize the job by the training-set R² score:

  R² > 0.99      → LINEAR  : memory scales with input; extrapolate confidently.
  R² < 0.10      → FLAT    : memory does not scale with input size.
  0.10 ≤ R² ≤ 0.99 → UNCLEAR : no usable model; fall back to plain BO.

The thresholds are the paper's (§III-C / §IV-B).  The model also carries the
constant overhead terms of §III-D: per-node framework+OS overhead and a
multiplicative leeway factor, which together turn the extrapolated *job*
requirement into a *total-cluster-memory* requirement.

The port's own numpy copy of the reference module `repro/core/memory_model.py`:
the port never imports the JAX package, and the two stay bit-equal.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np

__all__ = [
    "MemoryCategory",
    "MemoryModel",
    "fit_memory_model",
    "LINEAR_R2_THRESHOLD",
    "FLAT_R2_THRESHOLD",
]

LINEAR_R2_THRESHOLD = 0.99
FLAT_R2_THRESHOLD = 0.10


class MemoryCategory(enum.Enum):
    LINEAR = "linear"
    FLAT = "flat"
    UNCLEAR = "unclear"


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Fitted memory model for one job."""

    category: MemoryCategory
    slope: float  # bytes of memory per byte of input (LINEAR) else 0
    intercept: float  # bytes
    r2: float
    sizes: tuple  # profiling sample sizes (bytes)
    readings: tuple  # peak-memory readings (bytes)

    def estimate(self, input_size: float) -> float:
        """Extrapolated job memory requirement for ``input_size`` bytes.

        Only meaningful for LINEAR jobs; FLAT jobs return the mean reading;
        UNCLEAR jobs return NaN (caller must not rely on it).
        """
        if self.category is MemoryCategory.LINEAR:
            return self.slope * input_size + self.intercept
        if self.category is MemoryCategory.FLAT:
            return float(np.mean(self.readings))
        return float("nan")

    def total_cluster_requirement(
        self,
        input_size: float,
        *,
        per_node_overhead: float = 0.0,
        num_nodes: int = 0,
        leeway: float = 0.10,
    ) -> float:
        """Paper §III-D: job requirement + framework/OS overhead + leeway."""
        base = self.estimate(input_size)
        return base * (1.0 + leeway) + per_node_overhead * num_nodes


def _ols_r2(x: np.ndarray, y: np.ndarray) -> tuple:
    """Least-squares slope/intercept and training-set R²."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xm, ym = x.mean(), y.mean()
    sxx = np.sum((x - xm) ** 2)
    if sxx <= 0.0:  # degenerate: all sample sizes identical
        return 0.0, float(ym), 0.0
    slope = float(np.sum((x - xm) * (y - ym)) / sxx)
    intercept = float(ym - slope * xm)
    pred = slope * x + intercept
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - ym) ** 2))
    if ss_tot <= 0.0:
        # Perfectly constant readings: a constant model explains everything,
        # but there is by definition no correlation with input size -> R²=0.
        return slope, intercept, 0.0
    return slope, intercept, 1.0 - ss_res / ss_tot


def fit_memory_model(
    sizes: Sequence[float],
    readings: Sequence[float],
    *,
    linear_threshold: float = LINEAR_R2_THRESHOLD,
    flat_threshold: float = FLAT_R2_THRESHOLD,
) -> MemoryModel:
    """Fit + categorize memory readings per paper §III-C."""
    if len(sizes) != len(readings):
        raise ValueError("sizes and readings must have equal length")
    if len(sizes) < 2:
        raise ValueError("need at least two profiling samples")
    slope, intercept, r2 = _ols_r2(np.asarray(sizes), np.asarray(readings))
    # A *negative* slope with high R² is not the paper's "linear" growth
    # pattern (memory shrinking with more input is an artifact); treat as
    # unclear so the searcher falls back to the baseline.
    if r2 > linear_threshold and slope > 0:
        category = MemoryCategory.LINEAR
    elif r2 < flat_threshold:
        category = MemoryCategory.FLAT
    else:
        category = MemoryCategory.UNCLEAR
    if category is not MemoryCategory.LINEAR:
        slope_out, intercept_out = 0.0, float(np.mean(readings))
    else:
        slope_out, intercept_out = slope, intercept
    return MemoryModel(
        category=category,
        slope=slope_out,
        intercept=intercept_out,
        r2=float(r2),
        sizes=tuple(float(s) for s in sizes),
        readings=tuple(float(r) for r in readings),
    )
