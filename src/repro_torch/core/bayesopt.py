"""Bayesian-optimized iterative configuration search (paper §III-E).

Two searchers share one engine:

  * ``cherrypick_search``  — the baseline: plain Bayesian optimization with a
    Matérn-5/2 GP and Expected Improvement over the whole space (CherryPick,
    Alipourfard et al., NSDI'17): 3 random initial configs, then argmax-EI,
    stopping once max EI < 10 % of the best observed cost (and at least
    ``min_observations`` configs were tried).

  * ``ruya_search`` — the paper's contribution: the same engine, but run first
    over the memory-derived *priority group*; only after the group is
    exhausted does the search open up to the remaining configurations, with
    the GP retaining every observation made so far.

Port of `repro/core/bayesopt.py`: the host-side loop is the reference's,
line for line, and the BO step runs on ``device`` (the card unless the
caller passes ``device="cpu"``) through `fast_bo.SequentialProbe`.
Host-side randomness stays the caller's `np.random.Generator`, so a port
trace and a reference trace with the same seed draw the same init picks.

Both searchers can be run past their stopping criterion (``to_exhaustion``)
so the evaluation can measure "after how many iterations was the optimal /
near-optimal configuration first tried" (Table II) independently of when the
stop fired; the would-have-stopped iteration is recorded in the result.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import fast_bo
from repro_torch.core.search_space import SearchSpace
from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "BOSettings",
    "SearchTrace",
    "cherrypick_search",
    "ruya_search",
    "trial_budget",
]

CostFn = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class BOSettings:
    n_init: int = 3  # random initial configurations (CherryPick §4)
    ei_stop_rel: float = 0.10  # stop when max EI < 10 % of best cost
    min_observations: int = 6  # don't stop before this many trials
    max_iters: Optional[int] = None
    xi: float = 0.0


@dataclasses.dataclass
class SearchTrace:
    """Complete record of one search run."""

    tried: List[int]  # config indices in trial order
    costs: List[float]  # observed costs in trial order
    stop_iteration: Optional[int]  # 1-based iteration where the criterion fired
    phase_boundary: Optional[int]  # trials made in the priority phase (Ruya)

    @property
    def best_cost(self) -> float:
        return float(np.min(self.costs))

    @property
    def best_index(self) -> int:
        return self.tried[int(np.argmin(self.costs))]

    def iterations_until(self, threshold_cost: float) -> Optional[int]:
        """1-based iteration at which a cost ≤ threshold was first observed."""
        for i, c in enumerate(self.costs):
            if c <= threshold_cost:
                return i + 1
        return None


def trial_budget(n_prio: int, n_rem: int, settings: BOSettings) -> int:
    """Per-job trial budget — and therefore the packed-buffer capacity B.

    THE single source of this formula: B sets the static (B,B)
    factorization extent of the packed BO step, so the sequential and
    batched engines must compute it identically for their float32 traces
    to stay bit-identical.  The budget floor is the scripted init count —
    the sequential engine observes every init pick before its first
    budget check.
    """
    n_init = min(settings.n_init, n_prio)
    total = n_prio + n_rem
    if settings.max_iters is not None:
        total = min(total, max(settings.max_iters, n_init))
    return total


def _bo_loop(
    space: SearchSpace,
    cost_fn: CostFn,
    rng: np.random.Generator,
    candidate_order: Sequence[Sequence[int]],
    settings: BOSettings,
    to_exhaustion: bool,
    layout: str = "feature",
    device: DeviceLike = None,
) -> SearchTrace:
    """Shared engine.  ``candidate_order`` is a list of candidate *pools*;
    pool k+1 is only opened once pool k is exhausted (Ruya's two phases).
    The GP is always fit on every observation made so far."""
    device = resolve_device(device)  # raises before any trial without a card
    n = len(space)
    tried: List[int] = []
    costs: List[float] = []
    stop_iteration: Optional[int] = None
    phase_boundary: Optional[int] = None
    encoded_all = np.asarray(space.encoded(), np.float32)

    obs_mask = np.zeros(n, bool)

    # Packed-buffer capacity: `trial_budget` is shared with the fleet
    # engine, so both factorize (B,B) systems of identical static extent —
    # a prerequisite for bit-identical traces.
    pools_raw = [list(pool) for pool in candidate_order]
    n_prio = len(pools_raw[0]) if pools_raw else 0
    n_rem = sum(len(p) for p in pools_raw[1:])
    capacity = max(trial_budget(n_prio, n_rem, settings), 1)

    # Device-resident probe over the shared fleet_step program; built lazily
    # at the first BO step (a search that only runs scripted init picks, or
    # has empty pools, never touches the device).
    probe: Optional[fast_bo.SequentialProbe] = None

    def observe(idx: int) -> None:
        c = float(cost_fn(idx))
        tried.append(idx)
        costs.append(c)
        obs_mask[idx] = True

    for phase, pool in enumerate(pools_raw):
        pool = [int(i) for i in pool if not obs_mask[i]]
        if not pool:
            continue
        if phase >= 1 and phase_boundary is None:
            phase_boundary = len(tried)

        # Random initialization only in the first phase; later phases reuse
        # the GP knowledge gained so far (paper §III-E).
        if phase == 0:
            n_init = min(settings.n_init, len(pool))
            init = rng.choice(len(pool), size=n_init, replace=False)
            for idx in (pool[int(i)] for i in init):
                observe(idx)

        cand_mask = np.zeros(n, bool)
        cand_mask[np.asarray(pool, np.int64)] = True

        if probe is not None:
            probe.set_pool(cand_mask)

        while bool(np.any(cand_mask & ~obs_mask)):
            if settings.max_iters is not None and len(tried) >= settings.max_iters:
                return SearchTrace(tried, costs, stop_iteration, phase_boundary)
            if probe is None:
                probe = fast_bo.SequentialProbe(
                    encoded_all, capacity, xi=settings.xi, layout=layout,
                    device=device,
                )
                probe.set_pool(cand_mask)
                probe.start(obs_mask, tried, costs)
            pick, max_ei, best = probe.step(costs[-1] if costs else 0.0)
            # The threshold product is rounded to float32 to match the fleet
            # engine's on-device criterion bit-for-bit (both operands of the
            # comparison are then exactly representable float32 values).
            if (
                stop_iteration is None
                and len(tried) >= settings.min_observations
                and max_ei < float(np.float32(settings.ei_stop_rel) * np.float32(best))
            ):
                stop_iteration = len(tried)
                if not to_exhaustion:
                    return SearchTrace(tried, costs, stop_iteration, phase_boundary)
            observe(pick)

    return SearchTrace(tried, costs, stop_iteration, phase_boundary)


def cherrypick_search(
    space: SearchSpace,
    cost_fn: CostFn,
    rng: np.random.Generator,
    *,
    settings: BOSettings = BOSettings(),
    to_exhaustion: bool = False,
    layout: str = "feature",
    device: DeviceLike = None,
) -> SearchTrace:
    """Baseline: plain CherryPick BO over the full space.

    ``layout`` selects the packed step's geometry and tail — "feature" (EI
    over the full (B,n) block in plain PyTorch), "fused" (the CUDA
    EI/argmax kernel on the card, its plain version on the CPU) or "gather"
    (the blocks gathered from an (n,n) distance tensor).
    """
    return _bo_loop(
        space, cost_fn, rng, [list(range(len(space)))], settings,
        to_exhaustion, layout, device,
    )


def ruya_search(
    space: SearchSpace,
    cost_fn: CostFn,
    rng: np.random.Generator,
    priority: Sequence[int],
    remaining: Sequence[int],
    *,
    settings: BOSettings = BOSettings(),
    to_exhaustion: bool = False,
    layout: str = "feature",
    device: DeviceLike = None,
) -> SearchTrace:
    """Ruya: BO over the priority group first, then over the remaining space.

    With an empty ``remaining`` (unclear jobs, or a requirement every config
    satisfies) this degrades exactly to the baseline — the paper's fallback.
    ``layout`` as in `cherrypick_search`.
    """
    pools = [list(priority)] + ([list(remaining)] if len(remaining) else [])
    return _bo_loop(
        space, cost_fn, rng, pools, settings, to_exhaustion, layout, device
    )
