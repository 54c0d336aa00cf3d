"""Fully batched multi-job BO search: J searches in lockstep on one device.

Port of `repro/fleet/batched_engine.py`.  The sequential engine
(`repro_torch.core.bayesopt._bo_loop`) drives one job per Python-loop
iteration and pays the host's dispatch of about a hundred small ops per BO
step.  Here a lockstep chunk of jobs advances together: one `fleet_step`
call over the chunk's leading job axis applies the step to every job at
once, so the same host cost is spread over J jobs.

  * the per-job state (observation mask, packed trial log, targets and
    features: `fast_bo.FleetState`) lives on the device with a leading job
    axis, and `fleet_step` updates it in place (the role of the
    reference's `vmap` and buffer donation);
  * per-job geometry is the (n,d) float32 encoding (layouts "feature" and
    "fused") or the (n,n) distance tensor (layout "gather"), stacked into
    one contiguous (J,·,·) tensor per chunk;
  * the host only counts iterations: all bookkeeping, per-job stopping
    included, happens on the device, and with early stopping the host
    polls the done flags every `_POLL_PERIOD` steps.

Per-job structure is encoded as masks over the configuration axis:
`priority_mask` / `remaining_mask` delimit Ruya's two phases (CherryPick is
priority = everything, remaining = empty).  Jobs are grouped by (space
shape, packed capacity B): the packed factorizations run at extent B, so a
job runs at exactly the capacity the sequential engine would give it.

The reference pads a chunk of one job with an inert dummy row, because
XLA:CPU compiles batch extent 1 into a program with other float32
numerics.  PyTorch runs the same ops at any extent and no op reduces
across the job axis, so the port drops the dummy row: a chunk has exactly
its members' rows, and a job's trace does not depend on its chunk-mates
(`tests/test_torch_fleet.py`).

Since the `TuningSession` redesign the chunk lifecycle (group, admit, step,
retire) lives in `repro_torch.fleet.session`; `batched_search` below is the
one-shot shim, and this module keeps the lockstep update `_fleet_update`
and the chunking constants both share.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.bayesopt import BOSettings, SearchTrace, trial_budget
from repro_torch.core.fast_bo import _check_layout, fleet_step
from repro_torch.core.search_space import SearchSpace
from repro_torch.device import DeviceLike

__all__ = ["BatchedTrace", "batched_search"]


@dataclasses.dataclass
class BatchedTrace:
    """Trial logs for J searches, padded to the longest run.

    ``tried[j, k]`` is the k-th configuration index tried by job j (-1 pad);
    ``costs`` is aligned with ``tried``; ``stop_iteration``/``phase_boundary``
    are -1 where the event never happened.  ``job_trace(j)`` converts one row
    to the sequential engine's `SearchTrace`.
    """

    tried: np.ndarray  # (J, T) int32, -1 padded
    costs: np.ndarray  # (J, T) float64, aligned with tried
    n_tried: np.ndarray  # (J,) int32
    stop_iteration: np.ndarray  # (J,) int32, -1 = criterion never fired
    phase_boundary: np.ndarray  # (J,) int32, -1 = never left the priority phase

    def __len__(self) -> int:
        return self.tried.shape[0]

    def job_trace(self, j: int) -> SearchTrace:
        k = int(self.n_tried[j])
        stop = int(self.stop_iteration[j])
        pb = int(self.phase_boundary[j])
        return SearchTrace(
            tried=[int(i) for i in self.tried[j, :k]],
            costs=[float(c) for c in self.costs[j, :k]],
            stop_iteration=stop if stop >= 0 else None,
            phase_boundary=pb if pb >= 0 else None,
        )

    def traces(self) -> List[SearchTrace]:
        return [self.job_trace(j) for j in range(len(self))]


# Jobs are processed in lockstep chunks of at most this many rows, and with
# early stopping the host polls the done flags at this period (each poll
# waits for the device once).  Both are the reference's: together they
# decide when a chunk retires, and so which class-history snapshot a
# warm-started job submitted mid-flight sees.
_CHUNK = 8
_POLL_PERIOD = 8


def _fleet_update(
    state, geom, costs, prio_mask, rem_mask, init_picks, init_count,
    max_trials, min_obs, ei_stop_rel, to_exhaustion, *, xi: float,
    layout: str = "feature",
):
    """One lockstep iteration for a chunk of jobs: `fleet_step` over the
    chunk's job axis, updating ``state`` in place (returned)."""
    return fleet_step(
        state, geom, costs, prio_mask, rem_mask, init_picks, init_count,
        max_trials, min_obs, ei_stop_rel, to_exhaustion, xi, layout,
    )


def _as_space_list(
    spaces: Union[SearchSpace, Sequence[SearchSpace]], n_jobs: int
) -> List[SearchSpace]:
    if isinstance(spaces, SearchSpace):
        return [spaces] * n_jobs
    spaces = list(spaces)
    if len(spaces) != n_jobs:
        raise ValueError(f"{len(spaces)} spaces for {n_jobs} jobs")
    return spaces


def batched_search(
    spaces: Union[SearchSpace, Sequence[SearchSpace]],
    cost_tables: Sequence[np.ndarray],
    rngs: Sequence[np.random.Generator],
    *,
    priority: Optional[Sequence[Sequence[int]]] = None,
    remaining: Optional[Sequence[Sequence[int]]] = None,
    settings: BOSettings = BOSettings(),
    to_exhaustion: bool = False,
    layout: str = "feature",
    shard=None,
    devices=None,
    device: DeviceLike = None,
) -> BatchedTrace:
    """Run J independent BO searches in lockstep on ``device`` (the card
    unless the caller passes ``device="cpu"``).

    ``spaces`` may be one shared `SearchSpace` or one per job.  Jobs are
    grouped by (space shape, trial budget), each group at its own packed
    capacity.  ``cost_tables[j][i]`` is the cost job j observes for
    configuration i; the whole table lives on the device.
    ``priority``/``remaining`` give each job's Ruya split (omitted: plain
    CherryPick over the whole space).  The random initialization consumes
    ``rngs[j]`` exactly like the sequential engine.  ``layout`` is
    "feature", "fused" or "gather" (`fast_bo`).  ``shard``/``devices``
    shard the job axis over several devices (`repro_torch.fleet.sharding`;
    each job's trace is the unsharded one).

    A thin shim: every job is submitted to a fresh `TuningSession` (no
    profiling, no warm start, the splits verbatim), which is drained.
    """
    from repro_torch.fleet.driver import FleetJob
    from repro_torch.fleet.session import TuningSession

    _check_layout(layout)
    n_jobs = len(cost_tables)
    if len(rngs) != n_jobs:
        raise ValueError(f"{len(rngs)} rngs for {n_jobs} jobs")
    space_list = _as_space_list(spaces, n_jobs)
    if priority is None:
        priority = [list(range(len(s))) for s in space_list]
    if remaining is None:
        remaining = [[] for _ in range(n_jobs)]

    session = TuningSession(
        settings=settings, mode="cherrypick", warm_start=False,
        to_exhaustion=to_exhaustion, layout=layout, shard=shard,
        devices=devices, device=device,
    )
    for j, (space, table, rng) in enumerate(zip(space_list, cost_tables, rngs)):
        session.submit(
            FleetJob(name=f"job{j}", space=space, cost_table=table),
            rng,
            priority=[int(i) for i in priority[j]],
            remaining=[int(i) for i in remaining[j]],
        )
    outs = session.drain()

    budgets = [
        trial_budget(len(priority[j]), len(remaining[j]), settings)
        for j in range(n_jobs)
    ]
    max_T = max(max(budgets, default=0), 1)
    tried = np.full((n_jobs, max_T), -1, np.int32)
    out_costs = np.zeros((n_jobs, max_T), np.float64)
    n_tried = np.zeros(n_jobs, np.int32)
    stop = np.full(n_jobs, -1, np.int32)
    pb = np.full(n_jobs, -1, np.int32)
    for j, out in enumerate(outs):
        k = len(out.records)
        tried[j, :k] = [r.index for r in out.records]
        out_costs[j, :k] = [r.cost for r in out.records]
        n_tried[j] = k
        stop[j] = -1 if out.stop_iteration is None else out.stop_iteration
        pb[j] = -1 if out.phase_boundary is None else out.phase_boundary
    return BatchedTrace(
        tried=tried,
        costs=out_costs,
        n_tried=n_tried,
        stop_iteration=stop,
        phase_boundary=pb,
    )
