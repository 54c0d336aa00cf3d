"""End-to-end Ruya tuner: profile → categorize → split → two-phase BO search.

Port of `repro/core/tuner.py`, live-trial (``cost_fn``) path.  An
environment supplies a profiling run function ``run(sample_size) ->
(runtime_s, peak_mem_bytes)``, the full input size, the discrete search
space and a trial cost function ``cost_fn(config_index) -> float``; the
search runs on ``device`` (the card unless the caller passes
``device="cpu"``).

The reference's ``cost_table`` path replays recorded costs through its
batched fleet engine; the port's fleet slice is still to come (ROADMAP,
Queue 1, item 9), and until then that path raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

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

__all__ = ["RuyaReport", "canonical_objective", "run_ruya", "run_cherrypick"]

_FLEET_ITEM = (
    "the cost_table path runs on the fleet engine, which the port does not "
    "have yet (ROADMAP, Queue 1, item 9: fleet engine and session)"
)

# A tuning objective is "runtime", "cost", or a weight mapping over both
# (copy of the reference's `repro.fleet.session.canonical_objective`).
Objective = Union[str, Tuple[Tuple[str, float], ...]]
_OBJECTIVE_AXES = ("runtime", "cost")


def canonical_objective(objective) -> Objective:
    """Validate and canonicalize an objective spec (see `Objective`)."""
    if isinstance(objective, str):
        if objective not in _OBJECTIVE_AXES:
            raise ValueError(
                f"unknown objective {objective!r}; want one of "
                f"{_OBJECTIVE_AXES} or a weight mapping over them"
            )
        return objective
    if isinstance(objective, tuple):
        objective = dict(objective)
    if isinstance(objective, dict):
        extra = set(objective) - set(_OBJECTIVE_AXES)
        if extra or not objective:
            raise ValueError(
                f"objective weights must be over {_OBJECTIVE_AXES}, got "
                f"{sorted(objective) if objective else 'no axes'}"
            )
        weights = {k: float(v) for k, v in objective.items()}
        if min(weights.values()) < 0.0 or sum(weights.values()) <= 0.0:
            raise ValueError(
                f"objective weights must be >= 0 with a positive sum, "
                f"got {weights}"
            )
        return tuple(sorted(weights.items()))
    raise TypeError(
        f"objective must be a string or a weight mapping, got "
        f"{type(objective).__name__}"
    )


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
    """The full Ruya pipeline over live trials (``cost_fn``).

    ``profile_result`` can be injected to reuse an earlier profiling phase
    (the paper: profiling repeats only when the execution context changes).
    A live ``cost_fn`` observes one scalar per trial, so the objective
    must be "runtime".
    """
    if (cost_fn is None) == (cost_table is None):
        raise ValueError("provide exactly one of cost_fn / cost_table")
    if cost_table is not None:
        raise NotImplementedError(_FLEET_ITEM)
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
    """The baseline, for side-by-side evaluation (paper §IV-C)."""
    if (cost_fn is None) == (cost_table is None):
        raise ValueError("provide exactly one of cost_fn / cost_table")
    if cost_table is not None:
        raise NotImplementedError(_FLEET_ITEM)
    return cherrypick_search(
        space, cost_fn, rng, settings=settings, to_exhaustion=to_exhaustion,
        device=device,
    )
