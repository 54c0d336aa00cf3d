"""Single-machine profiling runs (paper §III-B).

The paper's procedure, made executable against any job abstraction:

  1. start with ~1 % of the dataset;
  2. adjust the sample iteratively so the profiling run's execution time lands
     between 30 s and 300 s — long enough to get past framework init, short
     enough to keep profiling cheap (runs longer than the cap are *canceled*
     at the cap and restarted with a smaller sample, and the canceled time is
     still charged to the profiling budget);
  3. run five linearly spaced sample sizes (the calibrated size and four
     smaller, equally spaced portions of it) and record peak memory for each;
  4. hand (sizes, readings) to the memory model for categorization.

The job abstraction is a callable ``run(sample_size) -> (runtime_s, peak_mem)``
so the same procedure profiles both the Scout-like Spark/Hadoop emulator and the
TPU tuner's compile-based memory probe.

The port's own numpy copy of the reference module `repro/core/profiler.py`:
the port never imports the JAX package, and the two stay bit-equal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

from repro_torch.core.memory_model import MemoryModel, fit_memory_model

__all__ = [
    "PermanentRunError",
    "ProfileResult",
    "ProfilingRunError",
    "TransientRunError",
    "profile_job",
    "schedule_sample_sizes",
]

RunFn = Callable[[float], Tuple[float, float]]


class ProfilingRunError(RuntimeError):
    """A profiling/probe run failed instead of returning a reading.

    This is the taxonomy the retry layer (`repro.fleet.retry`) classifies
    by: raise `TransientRunError` for failures worth retrying (preempted
    sample machine, OOM-killed sampler, lost connection) and
    `PermanentRunError` for failures no retry can fix (the job binary is
    broken, the dataset is gone).  Anything else that escapes a run
    callable is treated as permanent — an unknown failure must not be
    silently retried into a profiling budget.
    """


class TransientRunError(ProfilingRunError):
    """A profiling/probe run failed in a way a retry may fix."""


class PermanentRunError(ProfilingRunError):
    """A profiling/probe run failed in a way no retry can fix."""


@dataclasses.dataclass(frozen=True)
class ProfileResult:
    sizes: Tuple[float, ...]
    readings: Tuple[float, ...]
    total_time_s: float  # wall time spent profiling (incl. canceled runs)
    calibration_runs: int
    model: MemoryModel


def schedule_sample_sizes(calibrated: float, n_samples: int = 5) -> List[float]:
    """Five equally spaced portions of the calibrated sample (paper §III-B)."""
    if n_samples < 2:
        raise ValueError("need at least two samples to fit a line")
    return [calibrated * (i + 1) / n_samples for i in range(n_samples)]


def profile_job(
    run: RunFn,
    full_input_size: float,
    *,
    initial_fraction: float = 0.01,
    min_runtime_s: float = 30.0,
    max_runtime_s: float = 300.0,
    n_samples: int = 5,
    max_calibration_runs: int = 12,
) -> ProfileResult:
    """Calibrate the sample size, run the profiling sweep, fit the model."""
    sample = full_input_size * initial_fraction
    total_time = 0.0
    calibration_runs = 0

    # --- calibration: land the runtime inside [min, max] -------------------
    while calibration_runs < max_calibration_runs:
        runtime, _ = run(sample)
        calibration_runs += 1
        if runtime > max_runtime_s:
            # canceled at the cap; only the cap is charged (paper: "the
            # profiling job can be canceled and restarted").
            total_time += max_runtime_s
            sample *= max_runtime_s / (2.0 * runtime)
            continue
        total_time += runtime
        if runtime < min_runtime_s:
            if sample >= full_input_size:
                break  # even the full dataset is quick — profile as-is
            growth = min_runtime_s / max(runtime, 1e-9) * 1.5
            sample = min(sample * growth, full_input_size)
            continue
        break
    sample = min(sample, full_input_size)

    # --- sweep: five linearly spaced sizes ---------------------------------
    sizes = schedule_sample_sizes(sample, n_samples)
    readings: List[float] = []
    for s in sizes:
        runtime, peak_mem = run(s)
        total_time += min(runtime, max_runtime_s)
        readings.append(peak_mem)

    model = fit_memory_model(sizes, readings)
    return ProfileResult(
        sizes=tuple(sizes),
        readings=tuple(readings),
        total_time_s=total_time,
        calibration_runs=calibration_runs,
        model=model,
    )
