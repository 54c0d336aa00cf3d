"""End-to-end Ruya tuner: profile → categorize → split → two-phase BO search.

Port of `repro/core/tuner.py`.  An environment supplies a profiling run
function ``run(sample_size) -> (runtime_s, peak_mem_bytes)``, the full
input size, the discrete search space, and either a trial cost function
``cost_fn(config_index) -> float`` (live trials, the sequential engine's
device-resident probe) or a recorded ``cost_table`` (replay through the
fleet engine as a fleet of one, `repro_torch.fleet.driver.tune_fleet`).
Either runs on ``device``: the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.core.bayesopt import (
    BOSettings,
    SearchTrace,
    cherrypick_search,
    ruya_search,
)
from repro_torch.core.memory_model import MemoryModel
from repro_torch.core.profiler import ProfileResult, profile_job
from repro_torch.core.search_space import SearchSpace, split_search_space
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["RuyaReport", "run_ruya", "run_cherrypick"]


@dataclasses.dataclass
class RuyaReport:
    profile: ProfileResult
    priority: Tuple[int, ...]
    remaining: Tuple[int, ...]
    trace: SearchTrace

    @property
    def memory_model(self) -> MemoryModel:
        return self.profile.model


def run_ruya(
    *,
    profile_run: Optional[Callable[[float], Tuple[float, float]]] = None,
    full_input_size: float = 0.0,
    space: SearchSpace,
    cost_fn: Optional[Callable[[int], float]] = None,
    cost_table: Optional[np.ndarray] = None,
    rng: np.random.Generator,
    per_node_overhead: float = 0.0,
    leeway: float = 0.10,
    flat_fraction: float = 1.0 / 7.0,
    settings: BOSettings = BOSettings(),
    to_exhaustion: bool = False,
    profile_result: Optional[ProfileResult] = None,
    objective="runtime",
    device: DeviceLike = None,
) -> RuyaReport:
    """The full Ruya pipeline.

    ``profile_result`` can be injected to reuse an earlier profiling phase
    (the paper: profiling repeats only when the execution context changes).
    Costs come from ``cost_fn`` (live trials, the sequential engine) or
    from ``cost_table`` (replay on the fleet engine as a fleet of one).
    ``objective`` routes the replay's scoring ("runtime", "cost" or a
    weight mapping, `repro_torch.fleet.session.objective_table`); a live
    ``cost_fn`` observes one scalar per trial, so it takes "runtime" only.
    """
    if (cost_fn is None) == (cost_table is None):
        raise ValueError("provide exactly one of cost_fn / cost_table")
    if cost_table is not None:
        from repro_torch.fleet.driver import FleetJob, tune_fleet

        job = FleetJob(
            name="job",
            space=space,
            cost_table=np.asarray(cost_table, np.float64),
            full_input_size=full_input_size,
            profile_run=profile_run,
            profile_result=profile_result,
            per_node_overhead=per_node_overhead,
            leeway=leeway,
            flat_fraction=flat_fraction,
        )
        return tune_fleet(
            [job], [rng], settings=settings, to_exhaustion=to_exhaustion,
            objective=objective, device=device,
        )[0]
    from repro_torch.fleet.session import canonical_objective

    device = resolve_device(device)  # refuse before profiling without a card
    if canonical_objective(objective) != "runtime":
        raise ValueError(
            "non-runtime objectives need the cost_table path with pricing "
            "axes; a live cost_fn observes a single scalar per trial"
        )
    if profile_result is None and profile_run is None:
        raise ValueError("provide profile_run or profile_result")
    prof = profile_result or profile_job(profile_run, full_input_size)
    prio, rest = split_search_space(
        space,
        prof.model,
        full_input_size,
        per_node_overhead=per_node_overhead,
        leeway=leeway,
        flat_fraction=flat_fraction,
    )
    trace = ruya_search(
        space, cost_fn, rng, prio, rest,
        settings=settings, to_exhaustion=to_exhaustion, device=device,
    )
    return RuyaReport(
        profile=prof, priority=tuple(prio), remaining=tuple(rest), trace=trace
    )


def run_cherrypick(
    *,
    space: SearchSpace,
    cost_fn: Optional[Callable[[int], float]] = None,
    cost_table: Optional[np.ndarray] = None,
    rng: np.random.Generator,
    settings: BOSettings = BOSettings(),
    to_exhaustion: bool = False,
    device: DeviceLike = None,
) -> SearchTrace:
    """The baseline, for side-by-side evaluation (paper §IV-C), over a live
    ``cost_fn`` or a recorded ``cost_table`` (the fleet engine, as in
    `run_ruya`)."""
    if (cost_fn is None) == (cost_table is None):
        raise ValueError("provide exactly one of cost_fn / cost_table")
    if cost_table is not None:
        from repro_torch.fleet.driver import FleetJob, tune_fleet

        job = FleetJob(
            name="job", space=space, cost_table=np.asarray(cost_table, np.float64)
        )
        return tune_fleet(
            [job], [rng], mode="cherrypick", settings=settings,
            to_exhaustion=to_exhaustion, device=device,
        )[0].trace
    return cherrypick_search(
        space, cost_fn, rng, settings=settings, to_exhaustion=to_exhaustion,
        device=device,
    )
