"""Flora-style profile reuse across jobs with matching memory patterns.

Flora (Will et al., 2025) amortizes cluster tuning across a fleet by
classifying jobs and sharing knowledge within a class.  We apply the idea to
Ruya's most expensive phase: the single-machine profiling runs (minutes per
job, Table III).  A job's *memory signature* is derived from its fitted
`MemoryModel` — the category plus log-quantized slope and quantized
intercept — so two jobs whose memory scales the same way hash to the same
bucket regardless of small run-to-run noise.

The cache workflow, per job:

  1. run a cheap three-point *probe* (tiny samples, a fraction of the full
     five-run sweep) and fit a coarse model;
  2. if a profile with the probe's signature is cached → reuse it (hit);
  3. otherwise run the full §III-B profiling driver, store it under its own
     (full-fit) signature (miss).

The port's copy of the reference module `repro/fleet/profile_cache.py`.

Probing costs 3 short runs versus ~6+ longer ones for a full profile, so a
fleet of N jobs in C classes pays for C full profiles plus N cheap probes.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.memory_model import MemoryCategory, MemoryModel, fit_memory_model
from repro_torch.core.profiler import ProfileResult, profile_job

__all__ = ["MemorySignature", "ProfileCache", "probe_memory_model"]

RunFn = Callable[[float], Tuple[float, float]]

_GiB = 1024.0**3


@dataclasses.dataclass(frozen=True)
class MemorySignature:
    """Hashable memory-pattern class of a job (Flora-style)."""

    category: str
    slope_bucket: int  # round(log2(slope) / resolution), LINEAR only
    intercept_bucket: int  # round(intercept / quantum)

    @classmethod
    def of(
        cls,
        model: MemoryModel,
        *,
        slope_resolution: float = 0.5,
        intercept_quantum: float = 4.0 * _GiB,
    ) -> "MemorySignature":
        if model.category is MemoryCategory.LINEAR and model.slope > 0:
            slope_bucket = round(math.log2(model.slope) / slope_resolution)
        else:
            slope_bucket = 0
        intercept = model.intercept if math.isfinite(model.intercept) else 0.0
        return cls(
            category=model.category.value,
            slope_bucket=slope_bucket,
            intercept_bucket=round(intercept / intercept_quantum),
        )


def probe_memory_model(
    run: RunFn,
    full_input_size: float,
    *,
    fractions: Tuple[float, float, float] = (0.002, 0.006, 0.01),
) -> Tuple[MemoryModel, float]:
    """Cheap classification probe: a few tiny runs, coarse OLS fit.

    Returns (coarse model, wall-seconds spent probing).  The probe exists
    only to compute a `MemorySignature` — it is far too noisy to extrapolate
    a memory requirement from.
    """
    sizes = [full_input_size * f for f in fractions]
    spent = 0.0
    readings = []
    for s in sizes:
        runtime, peak = run(s)
        spent += runtime
        readings.append(peak)
    return fit_memory_model(sizes, readings), spent


class ProfileCache:
    """Shared `ProfileResult` store keyed by `MemorySignature`.

    Drift detection (opt-in via ``drift_tolerance``): recurring jobs DRIFT
    — datasets grow, per-row slopes amortize, overheads creep (see
    `repro_torch.cluster.workloads.drift_spec`) — and Flora-style class reuse is
    only safe while the cached profile still describes the job.  When a
    fresh probe lands in a cached class bucket but its coarse fit has
    moved beyond the tolerance from the cached profile's model, the hit is
    REFUSED: the job is flagged (``last_drift``), re-profiled in full, and
    re-classed — the fresh profile replaces the stale entry under the
    probe bucket and files under its own full-fit signature.  Callers
    (the `TuningSession`) additionally skip warm-seeding a flagged job
    from the stale class's trial history.

    Thread safety: a cache may be shared by concurrent submitters (the
    async service of ROADMAP item 15, or several sessions).  Every class-table
    mutation and the whole `get_or_profile` decision run under ``lock``
    (re-entrant, exposed) — the probe-classify → hit/miss → store
    sequence is one atomic unit, so two threads probing into the same
    empty bucket cannot both "miss" and double-profile, and the counters
    stay consistent.  ``last_drift`` is a per-call report: a caller that
    needs it must read it while still holding ``lock`` (the session's
    profile resolution does exactly that).
    """

    def __init__(
        self,
        *,
        slope_resolution: float = 0.5,
        intercept_quantum: float = 4.0 * _GiB,
    ) -> None:
        self.lock = threading.RLock()
        self._store: Dict[MemorySignature, ProfileResult] = {}
        self._slope_resolution = slope_resolution
        self._intercept_quantum = intercept_quantum
        self.hits = 0
        self.misses = 0
        self.drift_reprofiles = 0
        self.last_drift = False  # did the latest get_or_profile flag drift?
        self.probe_time_s = 0.0

    def __len__(self) -> int:
        with self.lock:
            return len(self._store)

    def signature(self, model: MemoryModel) -> MemorySignature:
        return MemorySignature.of(
            model,
            slope_resolution=self._slope_resolution,
            intercept_quantum=self._intercept_quantum,
        )

    def get(self, sig: MemorySignature) -> Optional[ProfileResult]:
        with self.lock:
            return self._store.get(sig)

    def put(self, sig: MemorySignature, profile: ProfileResult) -> None:
        with self.lock:
            self._store[sig] = profile

    def model_drifted(
        self, probe: MemoryModel, cached: MemoryModel, tolerance: float
    ) -> bool:
        """Has the job's coarse probe fit moved beyond ``tolerance`` from
        the cached class profile's model?  Category changes always drift;
        linear jobs compare relative slope deviation; every category
        compares the intercept against a ``tolerance`` fraction of the
        class quantum (signature buckets are coarse by design, so a probe
        can land in the bucket while the underlying fit has moved)."""
        if probe.category is not cached.category:
            return True
        if probe.category is MemoryCategory.LINEAR:
            ref = max(abs(cached.slope), 1e-12)
            if abs(probe.slope - cached.slope) / ref > tolerance:
                return True
        icp = probe.intercept if math.isfinite(probe.intercept) else 0.0
        icc = cached.intercept if math.isfinite(cached.intercept) else 0.0
        return abs(icp - icc) > tolerance * self._intercept_quantum

    def get_or_profile(
        self,
        run: RunFn,
        full_input_size: float,
        *,
        drift_tolerance: Optional[float] = None,
        **profile_kwargs,
    ) -> ProfileResult:
        """Probe-classify the job; reuse a cached profile or run a full one.

        With ``drift_tolerance`` set, a cached hit whose coarse probe fit
        has drifted beyond the tolerance is refused and the job is
        re-profiled and re-classed (see the class docstring);
        ``last_drift`` reports the decision for the latest call (read it
        under ``lock`` when other threads share the cache).

        The whole call holds ``lock``: the emulated run fns are cheap, and
        releasing it between the probe and the store would let two threads
        double-profile one class (and tear the hit/miss counters).
        """
        with self.lock:
            coarse, probe_s = probe_memory_model(run, full_input_size)
            self.probe_time_s += probe_s
            sig = self.signature(coarse)
            self.last_drift = False
            cached = self._store.get(sig)
            if cached is not None:
                if drift_tolerance is None or not self.model_drifted(
                    coarse, cached.model, drift_tolerance
                ):
                    self.hits += 1
                    return cached
                self.last_drift = True
                self.drift_reprofiles += 1
            else:
                self.misses += 1
            profile = profile_job(run, full_input_size, **profile_kwargs)
            if self.last_drift:
                # Re-class: the fresh profile REPLACES the stale class entry
                # under the probe bucket and files under its own full fit.
                self._store[sig] = profile
                self._store[self.signature(profile.model)] = profile
            else:
                # Store under the probe signature (the lookup key future jobs
                # will compute) and the full-fit signature, which can differ
                # on noisy jobs.
                self._store.setdefault(sig, profile)
                self._store.setdefault(self.signature(profile.model), profile)
            return profile
